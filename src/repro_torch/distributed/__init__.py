"""The port over a ``torch.distributed`` world: the meshes of ranks
(``mesh``: the join engine's ``(pod, data, model)`` mesh and the model
zoo's production mesh with its axis rules) and their collectives with
byte ledgers (``collectives``)."""
