"""FeaturePlaneStore — device-resident featurization planes (DESIGN.md §4),
on PyTorch.

FDJ's dominant recurring machine costs are step ⑦ (full-corpus feature
extraction) and moving the resulting planes host→device for step ⑧.  Both
are pure functions of (featurization spec version, corpus content), so in
the serving regime — the same tables joined repeatedly under different
predicates, thresholds, or freshly appended rows — they are pointless to
re-pay.  The store pins materialized planes on device, keyed by content
hash, and serves them back with zero extraction charges and zero
host→device plane bytes.

Keying.  One entry per (spec key+version, extraction identity, side,
corpus fingerprint).  The fingerprint (``corpus_fingerprint``) hashes the
side's record content, so appended rows produce a *new* fingerprint —
stale planes can never alias a grown corpus; delta extension
(join_service.JoinService.append_right) re-keys entries explicitly.

Each entry carries three representations of the same plane:

  * ``values`` — the raw extracted field values (host).  Kept because
    scalar re-normalization after a delta append (the p95–p5 scale is a
    whole-corpus statistic) must recompute from raw values to stay
    byte-identical with a cold materialization of the grown corpus;
  * ``host``   — the vectorized array (``core.featurize`` layout), used by
    the numpy engine and by refinement-time pair distances;
  * ``device`` — the same array as a torch tensor on the store's device,
    consumed by the cuda engine via ``ops.stage_planes`` (device-side
    assembly, no H2D).  On ``device="cpu"`` it is still a separate copy of
    ``host``, as an upload would be.

Eviction.  ``byte_budget`` bounds the device-resident total; inserts past
the budget evict least-recently-used entries (``get``/``put`` refresh
recency).  Hit/miss/eviction/H2D counters are surfaced per query through
``CostLedger.record_plane_traffic`` (core/costs.py serving fields).

Tenancy (DESIGN.md §8a).  The fleet fronts ONE store with N concurrent
tenants.  Content-hash keying makes cross-tenant dedup free — two tenants
joining byte-identical corpora share one resident entry — so the tenancy
layer only has to *attribute* and *arbitrate*:

  * every ``get``/``put``/``provide`` optionally names a ``tenant``; the
    entry records its owners (who can see it) and its *producer* (who
    paid the extraction + upload).  A hit whose producer is a different
    tenant counts as a ``dedup_hit`` — the per-tenant ledger line that
    proves the second tenant's cold query over a shared corpus paid $0;
  * ``register_tenant(name, byte_budget)`` declares a per-tenant byte
    budget.  A tenant's *charged* bytes split shared entries evenly
    across owners (an entry two tenants share charges each half), so
    dedup is rewarded in the accounting, not just in residency;
  * eviction is fair, budget-proportional, layered on the same LRU: when
    the global budget binds, the most-over-budget tenant (largest
    charged/budget ratio) releases its least-recently-used entry first —
    a shared entry merely drops that owner (the others keep it resident);
    a solely-owned one is actually evicted.  A tenant over its OWN budget
    releases its LRU entries the same way even when the global budget is
    fine, so one churning tenant can never squeeze the others out.

All public methods take one reentrant lock — the store is the fleet's
single shared mutable structure, hit concurrently by every worker thread
(tests/test_fleet.py pins serial≡concurrent byte-identity and counter
consistency).
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.featurize import FeatureData, FeaturizationSpec, vectorize
from repro_torch.device import resolve_device


def corpus_fingerprint(name: str, side: str, texts: Sequence,
                       fields: dict) -> str:
    """Content hash of one side of a join corpus.

    Covers the dataset name (extraction determinism is keyed by it), the
    record texts, and every schema field's values — anything that can
    change an extracted plane changes the fingerprint.
    """
    h = hashlib.blake2b(digest_size=16)
    h.update(f"{name}|{side}|{len(texts)}".encode())
    for t in texts:
        h.update(str(t).encode())
        h.update(b"\x00")
    for fname in sorted(fields):
        h.update(fname.encode())
        for v in fields[fname]:
            h.update(str(v).encode())
            h.update(b"\x00")
    return h.hexdigest()


def plane_key(spec: FeaturizationSpec, side: str, fingerprint: str) -> tuple:
    """Store key: spec version + extraction identity + side + corpus."""
    return (spec.key, spec.field, spec.distance_kind, side, fingerprint)


@dataclasses.dataclass
class PlaneEntry:
    key: tuple
    spec: FeaturizationSpec
    side: str
    values: list                  # raw extracted values (host)
    host: np.ndarray              # vectorized plane (featurize layout)
    device: torch.Tensor          # same plane on the store's device
    kind: str                     # embed | scalar
    scale: float
    producer: Optional[str] = None  # tenant that paid extraction + upload
    owners: set = dataclasses.field(default_factory=set)
    #   tenants sharing this entry (charged nbytes/len(owners) each)

    @property
    def nbytes(self) -> int:
        return int(self.host.nbytes)


class DevicePlaneSet(Sequence):
    """Materialized planes for one query: a drop-in for the FeatureData
    list the engines take, plus per-feature device-resident arrays.

    ``ops.stage_planes`` duck-types on ``device_l``/``device_r`` to
    assemble the kernel layout on device (zero H2D); the numpy engine and
    ``corpus_shape`` use the Sequence-of-FeatureData protocol unchanged.
    ``pack_cache`` memoizes assembled kernel layouts per padded geometry so
    repeated warm queries skip even the on-device reshuffle.

    ``device`` (the store's) is where the tensors live and where
    ``pack_features_device`` assembles.  ``mesh`` (the store's) is the
    sharded engine's default mesh for queries over this plane set: the
    engine lays the assembled planes out over the mesh's L axes once (a
    reshard memoized in ``pack_cache``), so warm sharded queries report 0
    reshard bytes.
    """

    def __init__(self, feats: list, dev_l: list, dev_r: list, *,
                 device: torch.device, mesh=None):
        self.feats = list(feats)
        self._dev_l = list(dev_l)
        self._dev_r = list(dev_r)
        self.device = device
        self.mesh = mesh
        self.pack_cache: dict = {}

    def __len__(self) -> int:
        return len(self.feats)

    def __getitem__(self, i):
        return self.feats[i]

    def device_l(self, i: int):
        return self._dev_l[i]

    def device_r(self, i: int):
        return self._dev_r[i]

    def slice_r(self, start: int) -> "DevicePlaneSet":
        """View of this plane set restricted to R rows [start, n_r) — the
        delta-join working set.  Host views are numpy slices; device views
        are on-device views (no transfer) at any row offset; the kernel
        gets new contiguous tensors from ``pack_features_device``."""
        feats = [FeatureData(f.spec, f.kind, f.data_l, f.data_r[start:],
                             scale=f.scale) for f in self.feats]
        return DevicePlaneSet(feats, self._dev_l,
                              [d[start:] for d in self._dev_r],
                              device=self.device, mesh=self.mesh)


class FeaturePlaneStore:
    """Byte-budget LRU cache of device-resident featurization planes.

    ``device`` holds every pinned plane ("cuda" unless the caller asks
    for "cpu"; CUDA without a GPU raises).  ``mesh`` (optional) attaches
    an execution mesh — e.g. the (pod, data, model) join mesh of
    ``distributed.mesh.make_join_mesh`` — to every served
    ``DevicePlaneSet``: the sharded engine takes it as its default mesh
    and memoizes the mesh layout on the set.
    """

    _PROVIDED_CACHE_MAX = 4

    def __init__(self, byte_budget: Optional[int] = None, *,
                 device="cuda", mesh=None):
        self.byte_budget = byte_budget
        self.mesh = mesh
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self._lock = threading.RLock()
        self._entries: OrderedDict = OrderedDict()
        self._provided: OrderedDict = OrderedDict()
        #   (spec identities, fp_l, fp_r) -> (store version, DevicePlaneSet):
        #   repeated warm queries get the *same* plane-set object back, so
        #   its pack_cache (assembled kernel layouts) survives across
        #   queries; invalidated by any store mutation via the version tag
        self._tenant_budgets: OrderedDict = OrderedDict()
        #   tenant -> byte budget (None = registered but unconstrained)
        self.version = 0              # bumped on any mutation (memo guard)
        self.hits = 0
        self.misses = 0
        self.puts = 0
        self.evictions = 0
        self.evicted_bytes = 0
        self.superseded = 0           # entries re-keyed/replaced (delta, rescale)
        self.bytes_to_device = 0      # H2D actually paid by the store
        self.dedup_hits = 0           # hits on a plane another tenant produced
        self.releases = 0             # ownership drops on still-shared entries

    # -- tenancy ------------------------------------------------------------

    def register_tenant(self, tenant: str,
                        byte_budget: Optional[int] = None) -> None:
        """Declare a tenant and its byte budget.  Budgets bound the
        tenant's *charged* bytes (shared entries split evenly across
        owners); exceeding one releases that tenant's own LRU entries —
        never another tenant's."""
        with self._lock:
            self._tenant_budgets[tenant] = byte_budget

    def tenant_bytes(self, tenant: str) -> float:
        """Bytes charged to ``tenant``: each owned entry contributes
        nbytes/len(owners) — dedup across tenants halves both bills."""
        with self._lock:
            return sum(e.nbytes / len(e.owners)
                       for e in self._entries.values()
                       if tenant in e.owners)

    def _note_hit(self, e: PlaneEntry, tenant: Optional[str]) -> None:
        if tenant is None:
            return
        if e.producer is not None and e.producer != tenant:
            self.dedup_hits += 1
        e.owners.add(tenant)

    # -- primitives ---------------------------------------------------------

    def _bump(self) -> None:
        """Any mutation invalidates memoized plane sets; purge them eagerly
        so stale sets (and the pack assemblies they pin) free promptly."""
        self.version += 1
        self._provided.clear()

    @property
    def resident_bytes(self) -> int:
        """Device bytes held by raw plane entries.  Derived artifacts —
        pack assemblies memoized on served DevicePlaneSets — are bounded
        by ``_PROVIDED_CACHE_MAX`` live sets but are NOT counted against
        ``byte_budget``; size the budget with that padding headroom in
        mind."""
        with self._lock:
            return sum(e.nbytes for e in self._entries.values())

    def get(self, spec: FeaturizationSpec, side: str, fingerprint: str,
            *, tenant: Optional[str] = None) -> Optional[PlaneEntry]:
        """Counted lookup: refreshes LRU recency on hit.  ``tenant`` joins
        the entry's owners; a hit on a plane a *different* tenant produced
        counts as a dedup hit (the fleet's shared-corpus proof)."""
        with self._lock:
            key = plane_key(spec, side, fingerprint)
            e = self._entries.get(key)
            if e is None:
                self.misses += 1
                return None
            self.hits += 1
            self._note_hit(e, tenant)
            self._entries.move_to_end(key)
            return e

    def peek(self, spec: FeaturizationSpec, side: str,
             fingerprint: str) -> Optional[PlaneEntry]:
        """Uncounted lookup (no recency refresh) — internal bookkeeping."""
        with self._lock:
            return self._entries.get(plane_key(spec, side, fingerprint))

    def put(self, spec: FeaturizationSpec, side: str, fingerprint: str,
            values: list, host: np.ndarray, kind: str, scale: float,
            *, device=None, tenant: Optional[str] = None) -> PlaneEntry:
        """Pin a plane.  Uploads ``host`` unless a ``device`` buffer is
        handed in (delta path: the caller already concatenated on device
        and paid only the delta's H2D via ``charge_upload``).  ``tenant``
        becomes the entry's producer (it paid) and joins the owners a
        superseded entry accumulated."""
        with self._lock:
            key = plane_key(spec, side, fingerprint)
            old = self._entries.pop(key, None)
            if old is not None:
                self.superseded += 1
            if device is None:
                # always a copy: on the CPU ``.to`` alone would alias host
                device = torch.from_numpy(host).to(self.device, copy=True)
                self.bytes_to_device += int(host.nbytes)
            owners = set(old.owners) if old is not None else set()
            if tenant is not None:
                owners.add(tenant)
            entry = PlaneEntry(key, spec, side, values, host, device, kind,
                               scale, producer=tenant, owners=owners)
            self._entries[key] = entry
            self.puts += 1
            self._bump()
            self._evict_to_budget(keep=key)
            return entry

    def drop(self, spec: FeaturizationSpec, side: str, fingerprint: str,
             *, superseded: bool = False) -> None:
        with self._lock:
            e = self._entries.pop(plane_key(spec, side, fingerprint), None)
            if e is not None:
                self._bump()
                if superseded:
                    self.superseded += 1
                else:
                    self.evictions += 1
                    self.evicted_bytes += e.nbytes

    def entries_for(self, side: str, fingerprint: str) -> list:
        """All resident entries of one corpus side (delta-append sweep)."""
        with self._lock:
            return [e for e in list(self._entries.values())
                    if e.side == side and e.key[4] == fingerprint]

    def charge_upload(self, nbytes: int) -> None:
        """Record H2D paid outside ``put`` (delta-row uploads)."""
        with self._lock:
            self.bytes_to_device += int(nbytes)

    # -- eviction -----------------------------------------------------------

    def _evict_entry(self, key: tuple) -> None:
        e = self._entries.pop(key)
        self.evictions += 1
        self.evicted_bytes += e.nbytes
        self._bump()

    def _release_lru(self, tenant: str, keep: tuple) -> bool:
        """Release ``tenant``'s least-recently-used entry: a shared entry
        merely drops this owner (it stays resident for the rest — dedup
        must never let one tenant evict another's working set); a solely
        owned one is evicted.  Returns False when the tenant owns nothing
        releasable (everything left is ``keep``)."""
        for key, e in list(self._entries.items()):    # LRU first
            if key == keep or tenant not in e.owners:
                continue
            e.owners.discard(tenant)
            if e.owners:
                self.releases += 1
            else:
                self._evict_entry(key)
            return True
        return False

    def _evict_lru_step(self, keep: tuple) -> bool:
        """Legacy global-LRU eviction step (no tenancy in play)."""
        if len(self._entries) <= 1:
            return False
        key = next(iter(self._entries))
        if key == keep:                # never evict the entry just pinned
            self._entries.move_to_end(key)
            key = next(iter(self._entries))
        self._evict_entry(key)
        return True

    def _fair_step(self, keep: tuple) -> bool:
        """One budget-proportional eviction step: unowned entries go first
        (nobody is charged for them), then the most-over-budget tenant —
        largest charged/budget ratio, charged bytes as the tie-break (a
        None budget ranks as unconstrained) — releases its LRU entry."""
        for key, e in self._entries.items():          # LRU first
            if key != keep and not e.owners:
                self._evict_entry(key)
                return True
        ranked = sorted(
            self._tenant_budgets,
            key=lambda t: (-(self.tenant_bytes(t) / self._tenant_budgets[t])
                           if self._tenant_budgets[t] else 0.0,
                           -self.tenant_bytes(t)))
        for t in ranked:
            if self._release_lru(t, keep):
                return True
        return False

    def _evict_to_budget(self, keep: tuple) -> None:
        # per-tenant budgets bind independently of the global one: a
        # tenant over ITS budget releases its own LRU entries even while
        # the store as a whole has room
        for t, b in list(self._tenant_budgets.items()):
            if b is None:
                continue
            while self.tenant_bytes(t) > b:
                if not self._release_lru(t, keep):
                    break
        if self.byte_budget is None:
            return
        while self.resident_bytes > self.byte_budget and len(self._entries) > 1:
            done = (self._fair_step(keep) if self._tenant_budgets
                    else self._evict_lru_step(keep))
            if not done:
                break

    # -- query-facing -------------------------------------------------------

    def provide(self, specs: Sequence[FeaturizationSpec], extractor,
                ledger, *, fp_l: str, fp_r: str,
                embedder=None, tenant: Optional[str] = None) -> DevicePlaneSet:
        """Materialize ``specs`` as a DevicePlaneSet, serving resident
        planes for free and extracting only the misses.

        ``extractor`` must expose ``extract_values(spec, side, ledger)``
        (full-corpus raw values, charging the ledger for records actually
        extracted — see data/simulated_llm.py).  A resident plane charges
        nothing and moves nothing to the device.

        Holds the store lock for the whole build: two tenants racing the
        same cold corpus serialize here, so the loser finds every plane
        resident and pays $0 extraction / 0 H2D (the fleet's dedup proof).
        """
        with self._lock:
            return self._provide(specs, extractor, ledger, fp_l=fp_l,
                                 fp_r=fp_r, embedder=embedder, tenant=tenant)

    def _provide(self, specs, extractor, ledger, *, fp_l, fp_r,
                 embedder, tenant) -> DevicePlaneSet:
        embedder = embedder or getattr(extractor, "_embedder", None)
        pkey = (tuple((s.key, s.field, s.distance_kind) for s in specs),
                fp_l, fp_r)
        memo = self._provided.get(pkey)
        if memo is not None and memo[0] == self.version:
            # same counters the per-entry path reports (all entries are
            # still resident — any eviction/put bumped the version)
            for spec in specs:
                self.get(spec, "l", fp_l, tenant=tenant)
                self.get(spec, "r", fp_r, tenant=tenant)
            return memo[1]
        feats, dev_l, dev_r = [], [], []
        for spec in specs:
            el = self.get(spec, "l", fp_l, tenant=tenant)
            er = self.get(spec, "r", fp_r, tenant=tenant)
            scale_ok = (el is None or er is None or el.kind == "embed"
                        or el.scale == er.scale)
            if el is not None and er is not None and scale_ok:
                feats.append(FeatureData(spec, el.kind, el.host, er.host,
                                         scale=el.scale))
                dev_l.append(el.device)
                dev_r.append(er.device)
                continue
            vals_l = el.values if el is not None else \
                extractor.extract_values(spec, "l", ledger)
            vals_r = er.values if er is not None else \
                extractor.extract_values(spec, "r", ledger)
            fd = vectorize(spec, vals_l, vals_r, embedder)
            # a side whose resident plane is still valid (embed kinds are
            # row-independent; scalar only if the joint scale held) keeps
            # its device buffer; anything else is (re)pinned.
            if el is not None and (fd.kind == "embed" or el.scale == fd.scale):
                dev_l.append(el.device)
            else:
                el = self.put(spec, "l", fp_l, vals_l, fd.data_l, fd.kind,
                              fd.scale, tenant=tenant)
                dev_l.append(el.device)
            if er is not None and (fd.kind == "embed" or er.scale == fd.scale):
                dev_r.append(er.device)
            else:
                er = self.put(spec, "r", fp_r, vals_r, fd.data_r, fd.kind,
                              fd.scale, tenant=tenant)
                dev_r.append(er.device)
            feats.append(FeatureData(spec, fd.kind, el.host, er.host,
                                     scale=fd.scale))
        planes = DevicePlaneSet(feats, dev_l, dev_r, device=self.device,
                                mesh=self.mesh)
        # memoize only if the whole working set survived the build: a
        # byte_budget smaller than one query can evict this query's own
        # entries mid-build, and a memo would then serve evicted arrays
        # (budget bypassed) while the counting replay misreports misses
        if all(plane_key(s, "l", fp_l) in self._entries
               and plane_key(s, "r", fp_r) in self._entries for s in specs):
            while len(self._provided) >= self._PROVIDED_CACHE_MAX:
                self._provided.popitem(last=False)
            self._provided[pkey] = (self.version, planes)
        return planes

    # -- observability ------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "hits": self.hits, "misses": self.misses, "puts": self.puts,
                "evictions": self.evictions,
                "evicted_bytes": self.evicted_bytes,
                "superseded": self.superseded,
                "bytes_to_device": self.bytes_to_device,
                "dedup_hits": self.dedup_hits,
                "releases": self.releases,
                "resident_bytes": self.resident_bytes,
                "entries": len(self._entries),
            }

    @staticmethod
    def delta(before: dict, after: dict) -> dict:
        """Per-query counter delta (levels — resident_bytes/entries — pass
        through as the 'after' value)."""
        out = {}
        for k, v in after.items():
            out[k] = v if k in ("resident_bytes", "entries") else v - before[k]
        return out
