"""Checkpoints of the training state, in the reference's format
(``checkpoint``)."""
