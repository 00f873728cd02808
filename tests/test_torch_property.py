"""Property-style sweeps of system invariants over the port.

Ports tests/test_property.py's sweeps other than the tokenizer and
pipeline cases (those are in tests/test_torch_pipeline.py).  Each test
draws many random instances from fixed seeds (``numpy.random``; each
seed is a parametrised case) and asserts the invariant on every draw:
threshold selection meets the recall target and is monotone in it,
cost-to-cover stays in bounds, CNF evaluation is sound under missing
values on every engine of the port, the CNF kernel's and the sweep's
plain versions equal the reference's Pallas kernels (interpret mode, as
the reference's own tests run them), and the cost ledger and oracle
charges add up.  Where the port draws a number (thresholds, costs to
cover, ledger dollars) it must equal the reference's on the same draw.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import generation
from repro_torch.core.costs import CostLedger
from repro_torch.core.featurize import FeaturizationSpec, vectorize
from repro_torch.core.scaffold import min_fpr_thresholds
from repro_torch.engine import ENGINES, get_engine
from repro_torch.kernels.fused_cnf_join import ref as cnf_ref
from repro_torch.kernels.fused_cnf_join.kernel import SCAL, VEC, cnf_join_block
from repro_torch.kernels.threshold_sweep.ops import sweep
from repro_torch.kernels.threshold_sweep.ref import threshold_sweep_ref


def _rand_instance(rng):
    """Random (clause-distance matrix, labels) like the old hypothesis
    strategy."""
    k = int(rng.integers(2, 61))
    f = int(rng.integers(1, 5))
    cd = rng.uniform(0, 1, size=(k, f)).astype(np.float32)
    labels = rng.random(k) < rng.uniform(0.1, 0.7)
    return cd, labels


@pytest.mark.parametrize("seed", range(8))
def test_threshold_selection_meets_observed_recall(seed):
    from repro.core.scaffold import min_fpr_thresholds as j_min_fpr
    rng = np.random.default_rng(1000 + seed)
    for _ in range(10):
        cd, labels = _rand_instance(rng)
        if labels.sum() == 0:
            continue
        res = min_fpr_thresholds(cd, labels, 0.8, device="cpu")
        want = j_min_fpr(cd, labels, 0.8)
        assert res.feasible == want.feasible
        if res.feasible:
            np.testing.assert_array_equal(res.theta, want.theta)
            sel = np.all(cd <= res.theta[None, :], axis=1)
            recall = (sel & labels).sum() / labels.sum()
            assert recall >= 0.8 - 1e-9
            assert 0.0 <= res.fpr <= 1.0


@pytest.mark.parametrize("seed", range(6))
def test_threshold_selection_monotone_in_target(seed):
    """Raising the recall target never lowers achieved recall, and (for the
    exactly-solved single-clause case) never lowers the optimal FPR —
    feasible sets are nested."""
    rng = np.random.default_rng(2000 + seed)
    for _ in range(10):
        k = int(rng.integers(5, 80))
        cd = rng.uniform(0, 1, size=(k, 1)).astype(np.float32)
        labels = rng.random(k) < 0.5
        if labels.sum() == 0:
            continue
        prev_fpr, prev_recall = -1.0, -1.0
        for target in (0.5, 0.7, 0.9, 1.0):
            res = min_fpr_thresholds(cd, labels, target, device="cpu")
            if not res.feasible:
                continue
            assert res.recall >= target - 1e-9
            assert res.recall >= prev_recall - 1e-12
            assert res.fpr >= prev_fpr - 1e-12
            prev_fpr, prev_recall = res.fpr, res.recall


@pytest.mark.parametrize("seed", range(6))
def test_cost_to_cover_bounds(seed):
    from repro.core import generation as j_generation
    rng = np.random.default_rng(3000 + seed)
    for _ in range(8):
        d, labels = _rand_instance(rng)
        n_pos, n_neg = int(labels.sum()), int((~labels).sum())
        c = generation.cost_to_cover(d, labels)
        assert c.shape == (n_pos,)
        assert np.all(c >= 0) and np.all(c <= n_neg)
        np.testing.assert_array_equal(c, j_generation.cost_to_cover(d, labels))


def _missing_fixture(seed):
    rng = np.random.default_rng(4000 + seed)
    n = int(rng.integers(6, 20))
    kinds = ["word_overlap", "semantic", "arithmetic"]
    feats, clauses, thetas = [], [], []
    miss_l = rng.random(n) < 0.3
    miss_r = rng.random(n) < 0.3
    for fi, kind in enumerate(kinds):
        if kind == "arithmetic":
            vals_l = [None if m else float(rng.uniform(0, 50)) for m in miss_l]
            vals_r = [None if m else float(rng.uniform(0, 50)) for m in miss_r]
        else:
            vals_l = [None if m else
                      f"tok{rng.integers(0, 9)} tok{rng.integers(0, 9)}"
                      for m in miss_l]
            vals_r = [None if m else
                      f"tok{rng.integers(0, 9)} tok{rng.integers(0, 9)}"
                      for m in miss_r]
        spec = FeaturizationSpec(f"f{fi}", "", kind, "llm", f"f{fi}")
        feats.append(vectorize(spec, vals_l, vals_r))
        clauses.append([fi])
        thetas.append(float(rng.uniform(0.05, 0.95)))
    return feats, clauses, thetas, miss_l, miss_r


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("seed", range(5))
def test_cnf_soundness_under_missing_values(seed, engine):
    """A pair whose clause features are all missing is never admitted when
    every theta < 1 — the missing encoding pins its distance to 1."""
    feats, clauses, thetas, miss_l, miss_r = _missing_fixture(seed)
    opts = {"numpy": {}, "cuda": dict(tl=32, tr=32, device="cpu"),
            "sharded": dict(tl=32, tr=32, device="cpu")}[engine]
    res = get_engine(engine, **opts).evaluate(feats, clauses, thetas)
    for (i, j) in res.candidates:
        assert not (miss_l[i] or miss_r[j]), \
            "pair with a missing clause feature admitted below theta<1"


@pytest.mark.parametrize("seed", range(5))
def test_cnf_kernel_equals_ref_random(seed):
    """The port's kernel wrapper on CPU tensors (its plain version) and
    its plain reference equal the reference's Pallas kernel (interpret
    mode) bit for bit on random CNFs."""
    import jax.numpy as jnp
    from repro.kernels.fused_cnf_join import ref as j_ref
    from repro.kernels.fused_cnf_join.kernel import cnf_join_block as j_block
    rng = np.random.default_rng(5000 + seed)
    for _ in range(3):
        n_clauses = int(rng.integers(1, 4))
        members = int(rng.integers(1, 4))
        fv, nl, nr, d = 2, 64, 64, 128
        el = rng.normal(size=(fv, nl, d)).astype(np.float32)
        er = rng.normal(size=(fv, nr, d)).astype(np.float32)
        el /= np.linalg.norm(el, axis=-1, keepdims=True)
        er /= np.linalg.norm(er, axis=-1, keepdims=True)
        sl = rng.uniform(0, 1.2, size=(2, nl)).astype(np.float32)
        sr = rng.uniform(0, 1.2, size=(2, nr)).astype(np.float32)
        clauses = tuple(
            tuple((VEC, int(rng.integers(0, fv))) if rng.random() < 0.5
                  else (SCAL, int(rng.integers(0, 2)))
                  for _ in range(members))
            for _ in range(n_clauses))
        thetas = tuple(float(rng.uniform(0.1, 0.9)) for _ in range(n_clauses))
        arrays = (el, er, sl, sr)
        want = np.asarray(j_block(*map(jnp.asarray, arrays), clauses, thetas,
                                  tl=32, tr=32, interpret=True))
        expect = np.asarray(j_ref.cnf_join_ref(*map(jnp.asarray, arrays),
                                               clauses, thetas))
        assert np.array_equal(j_ref.unpack_mask(want, nr), expect)
        tensors = tuple(map(torch.from_numpy, arrays))
        packed = cnf_join_block(*tensors, clauses, thetas, tl=32, tr=32)
        assert np.array_equal(packed.numpy().view(np.uint32), want)
        plain = cnf_ref.cnf_join_ref(*tensors, clauses, thetas)
        assert np.array_equal(plain.numpy(), expect)
        assert np.array_equal(cnf_ref.unpack_mask(packed, nr), expect)


@pytest.mark.parametrize("seed", range(5))
def test_sweep_kernel_equals_ref_random(seed):
    """The port's sweep (both routes' dispatcher, on the CPU) and its
    plain reference equal the reference's Pallas sweep (interpret mode)
    exactly."""
    import jax.numpy as jnp
    from repro.kernels.threshold_sweep.ops import sweep as j_sweep
    rng = np.random.default_rng(6000 + seed)
    for _ in range(3):
        k = int(rng.integers(10, 400))
        c = int(rng.integers(1, 5))
        g = int(rng.integers(1, 100))
        cd = rng.uniform(0, 1, size=(k, c)).astype(np.float32)
        labels = rng.random(k) < 0.4
        th = rng.uniform(0, 1, size=(g, c)).astype(np.float32)
        want = j_sweep(cd, labels, th, tg=64, tk=128, interpret=True)
        pos, sel = sweep(cd, labels, th, tg=64, tk=128, device="cpu")
        np.testing.assert_array_equal(pos, want[0])
        np.testing.assert_array_equal(sel, want[1])
        expect = threshold_sweep_ref(
            torch.from_numpy(cd), torch.from_numpy(labels.astype(np.float32)),
            torch.from_numpy(th)).numpy()
        np.testing.assert_allclose(pos, expect[:, 0], atol=1e-5)
        np.testing.assert_allclose(sel, expect[:, 1], atol=1e-5)


@pytest.mark.parametrize("seed", range(4))
def test_ledger_accounting_adds_up(seed):
    """total == sum of categories after any charge sequence; every charge
    is non-negative and increases exactly its own category; the dollars
    equal the reference ledger's after the same sequence."""
    from repro.core.costs import CostLedger as JLedger
    rng = np.random.default_rng(7000 + seed)
    led, jled = CostLedger(), JLedger()
    charges = [
        ("labeling", lambda l, t: l.charge_label(t, 1)),
        ("refinement", lambda l, t: l.charge_refine(t, 1)),
        ("construction", lambda l, t: l.charge_generation(t, t // 2 + 1)),
        ("inference", lambda l, t: l.charge_extraction(t, 1)),
        ("inference", lambda l, t: l.charge_embedding(t)),
    ]
    for _ in range(50):
        cat, fn = charges[int(rng.integers(0, len(charges)))]
        before = led.breakdown()
        t = int(rng.integers(1, 2000))
        fn(led, t)
        fn(jled, t)
        after = led.breakdown()
        assert after[cat] > before[cat]
        for k in ("labeling", "construction", "inference", "refinement"):
            if k != cat:
                assert after[k] == before[k]
    bd = led.breakdown()
    assert bd["total"] == pytest.approx(
        bd["labeling"] + bd["construction"] + bd["inference"]
        + bd["refinement"])
    assert led.total == pytest.approx(bd["total"])
    assert bd == jled.breakdown()


def test_oracle_labels_charge_ledger_per_call():
    """Oracle labeling cost is linear in the number of labeled pairs, and
    equal to the reference oracle's charge."""
    from repro.data.synth import products as j_products
    from repro_torch.data.synth import products
    ds, jds = products(n_products=40), j_products(n_products=40)
    oracle, joracle = ds.make_oracle(), jds.make_oracle()
    assert oracle.ledger.total == 0.0
    oracle.label_pairs([(0, 0)], kind="labeling")
    joracle.label_pairs([(0, 0)], kind="labeling")
    one = oracle.ledger.labeling
    assert one > 0 and one == joracle.ledger.labeling
    oracle.label_pairs([(1, 1), (2, 2)], kind="labeling")
    joracle.label_pairs([(1, 1), (2, 2)], kind="labeling")
    assert oracle.ledger.labeling > one
    assert oracle.ledger.refinement == 0.0
    assert oracle.ledger.breakdown() == joracle.ledger.breakdown()
