"""Shared launcher wiring: dataset generators + the common flag set
(dataset/size/seed, engine selection, device, streaming, trace output)
that ``launch/join.py``, ``launch/serve_join.py`` and
``launch/serve_fleet.py`` share."""

from __future__ import annotations

import argparse
from repro_torch.data import synth
from repro_torch.engine import ENGINES


def make_dataset(name: str, *, size: float = 1.0, seed: int = 0,
                 scale: float = 1.0):
    """The benchmark corpora at launcher scale.  ``size`` is the user's
    CLI multiplier; ``scale`` is the launcher's own base factor (the
    one-shot join launcher runs 2x the serving launchers' corpora)."""
    def n(base: int) -> int:
        return int(base * size * scale)

    gens = {
        "police_records": lambda: synth.police_records(
            n_incidents=n(300), reports_per_incident=3, seed=seed),
        "citations": lambda: synth.citations(n_docs=n(900), seed=seed),
        "movies": lambda: synth.movies_pages(n_movies=n(400), seed=seed),
        "products": lambda: synth.products(n_products=n(700), seed=seed),
        "categorize": lambda: synth.categorize(n_items=n(2000), seed=seed),
        "biodex": lambda: synth.biodex(n_notes=n(1500), seed=seed),
    }
    return gens[name]()


def add_common_flags(ap: argparse.ArgumentParser, *,
                     engine_default: str = "cuda"
                     ) -> argparse.ArgumentParser:
    """The flag set every join launcher shares."""
    ap.add_argument("--dataset", default="police_records")
    ap.add_argument("--engine", default=engine_default,
                    choices=list(ENGINES))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the threshold sweep and the cuda engine "
                         "run (cpu = the kernels' plain-torch versions)")
    ap.add_argument("--stream", action="store_true",
                    help="pipeline refinement over the step-② candidate "
                         "stream (FDJConfig.stream_refinement)")
    ap.add_argument("--size", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--target", type=float, default=0.9)
    ap.add_argument("--delta", type=float, default=0.1)
    ap.add_argument("--trace-out", default=None, metavar="FILE",
                    help="write a Perfetto/Chrome trace-event JSON of the "
                         "run (load in ui.perfetto.dev, or summarize with "
                         "python -m repro_torch.launch.trace_report FILE)")
    return ap

