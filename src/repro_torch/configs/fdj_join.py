"""FDJ — the paper's own configuration (§8.1 defaults).

T_R=0.9, T_P=1.0, delta=0.1; 50 positives for featurization generation +
scaffold, 200 for threshold selection; gamma=0.05; alpha/beta per §5.
The distributed join-step cell (for dry-run/roofline of the paper technique)
is built by ``repro.launch.join.build_join_cell``.
"""
from repro_torch.core.join import FDJConfig

CONFIG = FDJConfig(
    recall_target=0.9,
    precision_target=1.0,
    delta=0.1,
    gen_positives=50,
    thresh_positives=200,
    alpha=3,
    beta=20,
    gamma=0.05,
    max_iter=8,
    mc_trials=20000,
    block=4096,
    engine="numpy",
)


def smoke_config() -> FDJConfig:
    import dataclasses
    return dataclasses.replace(CONFIG, gen_positives=20, thresh_positives=80,
                               mc_trials=2000, block=512)
