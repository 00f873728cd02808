"""The join engine over a ``torch.distributed`` world: the
``(pod, data, model)`` mesh of ranks (``mesh``) and the byte ledger of its
collectives (``collectives``)."""
