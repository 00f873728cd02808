"""First-touch extraction charging of the port's simulated extractor.

Ports tests/test_simulated_llm.py's two charging tests: materializing
twice charges once, and ``extract_values`` charges exactly the rows it is
asked for, the full side then costing what a cold full extraction costs.
The dollars must equal the reference extractor's on the same corpus.
"""

import numpy as np
import pytest

from repro_torch.core.costs import CostLedger
from repro_torch.data import synth
from repro_torch.data.cnf_fixtures import representative_cnf
from repro_torch.data.simulated_llm import SimulatedExtractor


def _reference(n_incidents=10, seed=1):
    from repro.core.costs import CostLedger as JLedger
    from repro.data import synth as j_synth
    from repro.data.cnf_fixtures import representative_cnf as j_cnf
    from repro.data.simulated_llm import SimulatedExtractor as JExtractor
    ds = j_synth.police_records(n_incidents=n_incidents,
                                reports_per_incident=2, seed=seed)
    return ds, j_cnf(ds)[0], JExtractor(ds), JLedger()


def test_materialize_charges_first_touch_only():
    ds = synth.police_records(n_incidents=10, reports_per_incident=2, seed=1)
    specs, _, _ = representative_cnf(ds)
    ext = SimulatedExtractor(ds)
    led = CostLedger()
    ext.materialize(specs, led)
    cold = led.inference
    assert cold > 0
    ext.materialize(specs, led)                        # idempotent re-charge
    assert led.inference == cold
    # pair_distances over already-materialized records charges nothing new
    ext.pair_distances(specs, [(0, 0), (3, 7)], led)
    assert led.inference == cold
    _, j_specs, j_ext, j_led = _reference()
    j_ext.materialize(j_specs, j_led)
    assert cold == j_led.inference


def test_extract_values_charges_exactly_the_requested_rows():
    ds = synth.police_records(n_incidents=10, reports_per_incident=2, seed=1)
    specs, _, _ = representative_cnf(ds)
    spec = specs[0]
    ext = SimulatedExtractor(ds)
    led = CostLedger()
    head = ext.extract_values(spec, "r", led, idx=np.arange(0, 5))
    part = led.inference
    assert part > 0 and len(head) == 5
    # same rows again: free; remaining rows: the rest of the full-side cost
    ext.extract_values(spec, "r", led, idx=np.arange(0, 5))
    assert led.inference == part
    full_vals = ext.extract_values(spec, "r", led)
    assert len(full_vals) == ds.n_r
    ref = CostLedger()
    SimulatedExtractor(ds).extract_values(spec, "r", ref)
    assert led.inference == pytest.approx(ref.inference, rel=1e-9)
    # values agree with the cached extraction
    assert full_vals[:5] == head
    _, j_specs, j_ext, j_led = _reference()
    j_head = j_ext.extract_values(j_specs[0], "r", j_led,
                                  idx=np.arange(0, 5))
    assert (j_head, j_led.inference) == (head, part)
