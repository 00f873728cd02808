"""PyTorch + CUDA port of the FDJ join (the JAX package ``repro`` is the
reference it is held against; this package imports nothing from it).

Entry points: ``repro_torch.core.join.fdj_join`` and
``python -m repro_torch.launch.join``.  They run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""
