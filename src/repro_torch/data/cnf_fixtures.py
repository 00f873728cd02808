"""Representative CNF scaffolds for the synth datasets.

Shared by the engine parity tests (tests/test_engines.py) and the
engine-comparison benchmark (benchmarks/engines.py) so both exercise the
*same* decomposition — a drift between them would silently decouple what
is tested from what is measured.
"""

from __future__ import annotations

from repro_torch.core.featurize import FeaturizationSpec


def representative_cnf(ds):
    """(specs, clauses, thetas) for a dataset by its field schema.

    police_records gets the paper's running example (date conjunct,
    officer/location disjunct); anything else gets one word-overlap clause
    per leading field.
    """
    fields = list(ds.fields_l.keys())
    if "incident_date" in fields:
        specs = [
            FeaturizationSpec("incident_date", "", "arithmetic", "llm", "incident_date"),
            FeaturizationSpec("officer_names", "", "word_overlap", "llm", "officer_names"),
            FeaturizationSpec("location", "", "semantic", "llm", "location"),
        ]
        return specs, [[0], [1, 2]], [0.02, 0.35]
    specs, clauses, thetas = [], [], []
    for i, f in enumerate(fields[:2]):
        specs.append(FeaturizationSpec(f, "", "word_overlap", "llm", f))
        clauses.append([i])
        thetas.append(0.4)
    return specs, clauses, thetas
