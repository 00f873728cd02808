"""repro_torch's FeaturePlaneStore and device-side kernel-layout assembly
against the JAX reference.

``pack_features_device`` must write bit-identical arrays to the port's
host ``pack_features`` and to the reference's ``pack_features_device``,
for embed-only, scalar-only and mixed clauses and for ragged ``slice_r``
views; ``stage_planes`` moves 0 plane bytes to the device for resident
planes.  The store's keying, counters and LRU / fair eviction are ports
of tests/test_planes.py and tests/test_fleet.py's store tests, and the
same operation scripts on both stores leave identical counters.  Every
port store here lives on ``device="cpu"``.
"""

import numpy as np
import pytest
import torch

from repro.core.costs import CostLedger as JLedger
from repro.data import synth as j_synth
from repro.data.cnf_fixtures import representative_cnf as j_representative
from repro.data.simulated_llm import SimulatedExtractor as JExtractor
from repro.kernels.fused_cnf_join import ops as j_ops
from repro.serving.planes import (FeaturePlaneStore as JStore,
                                  corpus_fingerprint as j_fingerprint)
from repro_torch.core.costs import CostLedger
from repro_torch.core.featurize import FeaturizationSpec, vectorize
from repro_torch.data import synth
from repro_torch.data.cnf_fixtures import representative_cnf
from repro_torch.data.simulated_llm import SimulatedExtractor
from repro_torch.engine import get_engine
from repro_torch.kernels.fused_cnf_join import ops as cnf_ops
from repro_torch.serving.planes import FeaturePlaneStore, corpus_fingerprint


def _police(mod, n=12, seed=3):
    return mod.police_records(n_incidents=n, reports_per_incident=2,
                              seed=seed)


def _provided(ds, store=None, ledger=None):
    store = store or FeaturePlaneStore(device="cpu")
    ext = SimulatedExtractor(ds)
    specs, clauses, thetas = representative_cnf(ds)
    fp_l = corpus_fingerprint(ds.name, "l", ds.texts_l, ds.fields_l)
    fp_r = corpus_fingerprint(ds.name, "r", ds.texts_r, ds.fields_r)
    planes = store.provide(specs, ext, ledger or CostLedger(),
                           fp_l=fp_l, fp_r=fp_r)
    return store, ext, planes, specs, clauses, thetas, (fp_l, fp_r)


def _j_provided(ds):
    store = JStore()
    specs, clauses, thetas = j_representative(ds)
    fp_l = j_fingerprint(ds.name, "l", ds.texts_l, ds.fields_l)
    fp_r = j_fingerprint(ds.name, "r", ds.texts_r, ds.fields_r)
    return store.provide(specs, JExtractor(ds), JLedger(), fp_l=fp_l,
                         fp_r=fp_r), clauses


def _kinds(planes, clauses, which):
    """The representative clauses restricted to members of one kind (or
    all of them): the embed-only, scalar-only and mixed layouts."""
    if which == "mixed":
        return clauses
    kind = "embed" if which == "embed" else "scalar"
    out = [[f for f in c if planes[f].kind == kind] for c in clauses]
    return [c for c in out if c]


def _assert_bitwise(arrays_a, arrays_b):
    for a, b in zip(arrays_a, arrays_b):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def test_fingerprint_matches_reference():
    ds, jds = _police(synth), _police(j_synth)
    for side, texts, fields in (("l", ds.texts_l, ds.fields_l),
                                ("r", ds.texts_r, ds.fields_r)):
        assert corpus_fingerprint(ds.name, side, texts, fields) == \
            j_fingerprint(jds.name, side, getattr(jds, f"texts_{side}"),
                          getattr(jds, f"fields_{side}"))
    fp = corpus_fingerprint(ds.name, "r", ds.texts_r, ds.fields_r)
    grown = corpus_fingerprint(ds.name, "r", ds.texts_r + ["new row"],
                               {k: v + [v[0]] for k, v in ds.fields_r.items()})
    assert grown != fp


@pytest.mark.parametrize("mk,which", [
    ("police", "embed"), ("police", "scalar"), ("police", "mixed"),
    ("citations", "embed")])
def test_device_pack_matches_host_pack_and_reference(mk, which):
    make = {"police": lambda m: _police(m),
            "citations": lambda m: m.citations(n_docs=37, seed=9)}[mk]
    ds = make(synth)
    _, _, planes, specs, clauses, _, _ = _provided(ds)
    jplanes, jclauses = _j_provided(make(j_synth))
    assert jclauses == clauses
    clauses = _kinds(planes, clauses, which)
    kinds = {planes[f].kind for c in clauses for f in c}
    assert kinds == ({"embed", "scalar"} if which == "mixed" else
                     {"embed" if which == "embed" else "scalar"})
    feats = SimulatedExtractor(ds).materialize(specs, CostLedger())
    for tl, tr in ((32, 64), (64, 128)):
        host = cnf_ops.pack_features(feats, clauses, tl=tl, tr=tr)
        dev = cnf_ops.pack_features_device(planes, clauses, tl=tl, tr=tr)
        ref = j_ops.pack_features_device(jplanes, clauses, tl=tl, tr=tr)
        assert all(isinstance(t, torch.Tensor) and t.is_contiguous()
                   for t in dev[:4])
        _assert_bitwise(host[:4], [t.numpy() for t in dev[:4]])
        _assert_bitwise(ref[:4], [t.numpy() for t in dev[:4]])
        assert host[4:] == dev[4:] == tuple(ref[4:])   # kclauses, n_l, n_r
    assert len(planes.pack_cache) == 2                 # one per geometry


@pytest.mark.parametrize("off", [1, 5, 7])
def test_ragged_slice_r_views_pack_bitwise(off):
    """The delta join's working set: R views at any row offset assemble
    to new contiguous tensors, bit-identical to packing the sliced host
    planes and to the reference's assembly of its own view."""
    ds = synth.citations(n_docs=37, seed=9)
    _, _, planes, specs, clauses, _, _ = _provided(ds)
    jplanes, _ = _j_provided(j_synth.citations(n_docs=37, seed=9))
    sub, jsub = planes.slice_r(off), jplanes.slice_r(off)
    for i in range(len(planes)):
        view, full = sub.device_r(i), planes.device_r(i)
        assert view.data_ptr() == \
            full.data_ptr() + off * full.stride(0) * full.element_size()
        np.testing.assert_array_equal(view.numpy(),
                                      planes.device_r(i).numpy()[off:])
        np.testing.assert_array_equal(sub[i].data_l, planes[i].data_l)
    dev = cnf_ops.pack_features_device(sub, clauses, tl=32, tr=64)
    host = cnf_ops.pack_features(list(sub), clauses, tl=32, tr=64)
    ref = j_ops.pack_features_device(jsub, clauses, tl=32, tr=64)
    _assert_bitwise(host[:4], [t.numpy() for t in dev[:4]])
    _assert_bitwise(ref[:4], [t.numpy() for t in dev[:4]])
    assert dev[6] == ds.n_r - off


def test_stage_planes_reports_zero_h2d_for_resident_planes():
    ds = _police(synth)
    _, _, planes, specs, clauses, thetas, _ = _provided(ds)
    feats = SimulatedExtractor(ds).materialize(specs, CostLedger())
    cold = cnf_ops.stage_planes(feats, clauses, tl=32, tr=64, device="cpu")
    warm = cnf_ops.stage_planes(planes, clauses, tl=32, tr=64, device="cpu")
    assert cold.bytes_h2d > 0 and warm.bytes_h2d == 0
    _assert_bitwise([a.numpy() for a in cold.arrays],
                    [a.numpy() for a in warm.arrays])
    # the cuda engine fed from the store: same candidates, 0 bytes moved
    eng = get_engine("cuda", tl=32, tr=64, device="cpu")
    got, want = eng.evaluate(planes, clauses, thetas), \
        eng.evaluate(feats, clauses, thetas)
    assert got.candidates == want.candidates
    assert got.stats.bytes_h2d == 0 and want.stats.bytes_h2d > 0


def test_store_device_planes_are_copies():
    """On the CPU the "device" plane is still a separate buffer, as an
    upload would be: writing the host array leaves it unchanged."""
    store = FeaturePlaneStore(device="cpu")
    spec = FeaturizationSpec("a", "", "word_overlap", "llm", "a")
    fd = vectorize(spec, ["x y"] * 8, ["x"] * 8)
    e = store.put(spec, "l", "fp", ["x y"] * 8, fd.data_l, "embed", 1.0)
    assert e.device.device == torch.device("cpu")
    before = e.device.clone()
    fd.data_l[:] = 7.0
    assert torch.equal(e.device, before)
    assert store.bytes_to_device == fd.data_l.nbytes


# --- provide: hits, misses, charges ----------------------------------------

def test_provide_charges_cold_then_serves_free():
    ds = _police(synth)
    led1 = CostLedger()
    store, ext, planes, specs, *_, fps = _provided(ds, ledger=led1)
    assert led1.inference > 0
    assert store.misses == 2 * len(specs) and store.hits == 0
    assert store.bytes_to_device == sum(
        f.data_l.nbytes + f.data_r.nbytes for f in planes.feats)
    led2 = CostLedger()
    warm = store.provide(specs, SimulatedExtractor(ds), led2,
                         fp_l=fps[0], fp_r=fps[1])
    assert led2.inference == 0.0 and store.hits == 2 * len(specs)
    ref = SimulatedExtractor(ds).materialize(specs, CostLedger())
    for got, want in zip(warm.feats, ref):
        np.testing.assert_array_equal(got.data_l, want.data_l)
        np.testing.assert_array_equal(got.data_r, want.data_r)
        assert got.scale == want.scale
    # the reference store charges and counts the same
    jds = _police(j_synth)
    jstore = JStore()
    jled = JLedger()
    jspecs = j_representative(jds)[0]
    jfp = (j_fingerprint(jds.name, "l", jds.texts_l, jds.fields_l),
           j_fingerprint(jds.name, "r", jds.texts_r, jds.fields_r))
    jstore.provide(jspecs, JExtractor(jds), jled, fp_l=jfp[0], fp_r=jfp[1])
    jstore.provide(jspecs, JExtractor(jds), JLedger(), fp_l=jfp[0],
                   fp_r=jfp[1])
    assert led1.breakdown() == jled.breakdown()
    assert store.snapshot() == jstore.snapshot()


def test_provide_is_sequence_of_feature_data():
    ds = _police(synth)
    _, _, planes, specs, clauses, thetas, _ = _provided(ds)
    assert len(planes) == len(specs)
    ref = get_engine("numpy").evaluate(
        SimulatedExtractor(ds).materialize(specs, CostLedger()),
        clauses, thetas)
    got = get_engine("numpy").evaluate(planes, clauses, thetas)
    assert got.candidates == ref.candidates


# --- LRU and fair eviction ---------------------------------------------------

def _spec(mod_spec, name):
    return mod_spec(name, "", "word_overlap", "llm", name)


def _script_stores(script):
    """Run one operation script on a port store and a reference store;
    returns both."""
    from repro.core.featurize import FeaturizationSpec as JSpec
    stores = []
    for store_cls, spec_cls, kw in ((FeaturePlaneStore, FeaturizationSpec,
                                     {"device": "cpu"}),
                                    (JStore, JSpec, {})):
        stores.append(script(lambda budget=None: store_cls(budget, **kw),
                             lambda name: _spec(spec_cls, name)))
    return stores


def _put(store, spec, name, tenant=None, n=64):
    """Pin one n*4-byte scalar plane keyed by ``name``."""
    return store.put(spec(name), "l", "fp", [None] * n,
                     np.zeros(n, np.float32), "scalar", 1.0, tenant=tenant)


def _get(store, spec, name, tenant=None):
    return store.get(spec(name), "l", "fp", tenant=tenant)


def test_byte_budget_evicts_lru():
    def script(make, spec):
        vals = [f"tok {i}" for i in range(16)]
        fd = vectorize(FeaturizationSpec("a", "", "word_overlap", "llm", "a"),
                       vals, vals)
        nbytes = fd.data_l.nbytes
        store = make(3 * nbytes)
        for name in ("a", "b", "c"):
            store.put(spec(name), "l", "fp", vals, fd.data_l, "embed", 1.0)
        assert store.resident_bytes == 3 * nbytes and store.evictions == 0
        store.get(spec("a"), "l", "fp")          # b is now LRU
        store.put(spec("c"), "r", "fp", vals, fd.data_r, "embed", 1.0)
        assert store.evictions == 1 and store.evicted_bytes == nbytes
        assert store.peek(spec("b"), "l", "fp") is None
        assert store.peek(spec("a"), "l", "fp") is not None
        return store.snapshot()
    got, want = _script_stores(script)
    assert got == want


def test_unbudgeted_store_never_evicts():
    def script(make, spec):
        store = make()
        fd = vectorize(FeaturizationSpec("a", "", "word_overlap", "llm", "a"),
                       ["x"] * 8, ["x"] * 8)
        for i in range(20):
            store.put(spec("a"), "l", f"fp{i}", ["x"] * 8, fd.data_l,
                      "embed", 1.0)
        assert store.evictions == 0 and store.snapshot()["entries"] == 20
        return store.snapshot()
    got, want = _script_stores(script)
    assert got == want


def test_counter_delta_between_snapshots():
    store = FeaturePlaneStore(device="cpu")
    spec = FeaturizationSpec("a", "", "word_overlap", "llm", "a")
    fd = vectorize(spec, ["x"] * 8, ["x"] * 8)
    store.put(spec, "l", "fp", ["x"] * 8, fd.data_l, "embed", 1.0)
    s0 = store.snapshot()
    store.get(spec, "l", "fp")
    store.get(spec, "l", "other")
    d = FeaturePlaneStore.delta(s0, store.snapshot())
    assert d["hits"] == 1 and d["misses"] == 1 and d["bytes_to_device"] == 0
    assert d["resident_bytes"] == store.resident_bytes


def test_shared_entry_splits_charged_bytes():
    def script(make, spec):
        store = make()
        store.register_tenant("a")
        store.register_tenant("b")
        _put(store, spec, "p", tenant="a")
        e = _get(store, spec, "p", tenant="b")
        assert e.owners == {"a", "b"} and e.producer == "a"
        assert store.dedup_hits == 1
        assert store.tenant_bytes("a") == store.tenant_bytes("b") == 128.0
        return store.snapshot()
    got, want = _script_stores(script)
    assert got == want


def test_tenant_budget_releases_only_own_entries():
    def script(make, spec):
        store = make()
        store.register_tenant("a", byte_budget=300)
        store.register_tenant("b")
        _put(store, spec, "a1", tenant="a")
        _put(store, spec, "b1", tenant="b")
        _put(store, spec, "a2", tenant="a")      # a over budget: a1 goes
        assert _get(store, spec, "a1") is None and store.evictions == 1
        assert _get(store, spec, "b1") is not None
        assert _get(store, spec, "a2") is not None
        assert store.tenant_bytes("a") == 256.0
        return store.snapshot()
    got, want = _script_stores(script)
    assert got == want


def test_tenant_budget_on_shared_entry_drops_owner_keeps_entry():
    def script(make, spec):
        store = make()
        store.register_tenant("a", byte_budget=300)
        store.register_tenant("b")
        _put(store, spec, "p", tenant="a")
        _get(store, spec, "p", tenant="b")
        _put(store, spec, "a2", tenant="a")      # a releases its share of p
        e = _get(store, spec, "p")
        assert e is not None and e.owners == {"b"}
        assert store.releases == 1 and store.evictions == 0
        assert store.tenant_bytes("a") == store.tenant_bytes("b") == 256.0
        return store.snapshot()
    got, want = _script_stores(script)
    assert got == want


def test_global_budget_evicts_unowned_before_owned():
    def script(make, spec):
        store = make(600)
        store.register_tenant("a")
        _put(store, spec, "stray")
        _put(store, spec, "a1", tenant="a")
        _put(store, spec, "a2", tenant="a")      # 768 > 600
        assert _get(store, spec, "stray") is None
        assert _get(store, spec, "a1") is not None
        assert _get(store, spec, "a2") is not None
        return store.snapshot()
    got, want = _script_stores(script)
    assert got == want


def test_global_budget_releases_most_loaded_tenant_first():
    def script(make, spec):
        store = make(700)
        store.register_tenant("a")
        store.register_tenant("b")
        _put(store, spec, "a1", tenant="a")
        _put(store, spec, "b1", tenant="b")
        _put(store, spec, "a2", tenant="a")      # a: 512, b: 256; 768 > 700
        assert _get(store, spec, "a1") is None
        assert _get(store, spec, "b1") is not None
        assert _get(store, spec, "a2") is not None
        return store.snapshot()
    got, want = _script_stores(script)
    assert got == want


def test_no_tenants_falls_back_to_plain_lru():
    def script(make, spec):
        store = make(600)
        for name in ("p1", "p2", "p3"):
            _put(store, spec, name)
        assert _get(store, spec, "p1") is None
        assert _get(store, spec, "p2") is not None
        assert _get(store, spec, "p3") is not None
        return store.snapshot()
    got, want = _script_stores(script)
    assert got == want


def test_provide_dedups_across_tenants():
    ds = _police(synth)
    store = FeaturePlaneStore(device="cpu")
    store.register_tenant("a")
    store.register_tenant("b")
    specs, *_ = representative_cnf(ds)
    fp_l = corpus_fingerprint(ds.name, "l", ds.texts_l, ds.fields_l)
    fp_r = corpus_fingerprint(ds.name, "r", ds.texts_r, ds.fields_r)
    led_a, led_b = CostLedger(), CostLedger()
    store.provide(specs, SimulatedExtractor(ds), led_a, fp_l=fp_l,
                  fp_r=fp_r, tenant="a")
    h2d_after_a = store.bytes_to_device
    store.provide(specs, SimulatedExtractor(ds), led_b, fp_l=fp_l,
                  fp_r=fp_r, tenant="b")
    assert led_a.inference > 0 and led_b.inference == 0.0
    assert store.bytes_to_device == h2d_after_a
    assert store.dedup_hits >= 2 * len(specs)
    assert store.tenant_bytes("a") == store.tenant_bytes("b") > 0


def test_stage_planes_refuses_planes_on_another_device():
    """Resident planes are never moved silently: planes that live on one
    device and an engine on another raise."""
    from repro_torch.serving.planes import DevicePlaneSet
    ds = _police(synth)
    _, _, planes, _, clauses, _, _ = _provided(ds)
    elsewhere = DevicePlaneSet(planes.feats, [planes.device_l(i) for i in
                                              range(len(planes))],
                               [planes.device_r(i) for i in
                                range(len(planes))],
                               device=torch.device("meta"))
    with pytest.raises(ValueError, match="resident on meta"):
        cnf_ops.stage_planes(elsewhere, clauses, tl=32, tr=64, device="cpu")
