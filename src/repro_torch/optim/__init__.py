"""The training path's optimizer (``adamw``)."""
