"""Static lock-order analysis over the port's threaded stack.

The port takes ``threading`` locks in the fleet (``serving/fleet.py``),
the plane store (``serving/planes.py``), the service's plan library
(``serving/join_service.py``), the ring engine (``engine/sharded.py``),
the collective ledger (``distributed/collectives.py``), the kernel
wrappers and their build (``kernels/*``) and the trace and metrics
registries (``obs/*``), with worker threads crossing the pump and fleet
boundaries.  This module is the machine check that no lock-order cycle
and no blocking pull inside a critical section lands (the port of the
JAX package's ``analysis/lockgraph.py``, reading ``src/repro_torch``).

What it does, per ``build_lock_graph(sources)``:

  1. **Lock discovery** — every ``threading.Lock/RLock/Condition()``
     construction becomes a named node: ``self._lock = threading.Lock()``
     in class ``C`` of module ``m`` is ``m.C._lock``; class-level and
     module-level locks name accordingly; a function-local construction
     (the per-key lease lock) names ``m.C.func.<var>``.  The node records
     its construction line — the key the runtime witness (witness.py)
     uses to map real locks back onto static nodes.
  2. **Acquisition extraction** — ``with`` items, ``.acquire()`` calls,
     and ``@contextmanager`` functions that hold locks *at their yield*
     (``PlanLibrary.lease`` holds the per-key lock at yield, so the
     caller's with-body runs under it; ``BandScheduler.step`` releases
     before yield, so its body runs unlocked — both are modeled).
  3. **Interprocedural edges** — per-function summaries of "locks this
     may acquire (transitively)" are propagated to a fixpoint over a
     resolved call graph (receiver types inferred from constructor
     assignments and annotations; untyped receivers fall back to
     unique-name matching behind a stdlib-method denylist so dict
     ``.get``/``.put`` can never fabricate an edge).  Holding ``h`` while
     calling anything that may acquire ``a`` adds edge ``h -> a``.
  4. **Checks** — a cycle among distinct nodes (potential deadlock), a
     same-thread re-acquisition path on a non-reentrant ``Lock``, and a
     *blocking call under any held lock* are each failing findings.  The
     blocking surface is the reference's (oracle ``label_pairs``,
     ``Future.result``, ``queue.put/get``, ``time.sleep``,
     ``Thread.join``; ``Condition.wait`` exempts its own lock) with the
     port's host syncs in place of ``jax.device_get`` (``.synchronize()``
     on ``torch.cuda``, an event or a stream; ``.cpu()``, ``.numpy()``,
     ``.item()``, ``.tolist()``) and the blocking ``torch.distributed``
     calls (collectives, point-to-point, group and world creation).
     Deliberate holds are waived explicitly in ``BLOCKING_WAIVERS`` with
     a reason — waivers are reported, never silent.

The graph renders as text (CLI) and DOT.  ``tests/test_torch_analysis.py``
pins both the clean verdict on the port's tree and a seeded violation
per check.
"""

from __future__ import annotations

import ast
import dataclasses
import fnmatch
from typing import Optional

from repro_torch.analysis.findings import Finding, iter_py_sources, module_name

# threading constructors that create a lock node (Condition's underlying
# lock is an RLock, so re-entry on one Condition is not a self-deadlock)
_LOCK_CTORS = ("Lock", "RLock", "Condition")

# method names that NEVER resolve by bare name against repo classes: the
# stdlib container/sync surface.  An untyped ``d.get(...)`` must not
# resolve to ``FeaturePlaneStore.get`` and fabricate a lock edge.
_NAME_DENYLIST = frozenset({
    "get", "put", "pop", "popitem", "setdefault", "keys", "values",
    "items", "update", "append", "appendleft", "extend", "insert",
    "remove", "sort", "reverse", "clear", "copy", "add", "discard",
    "union", "intersection", "move_to_end", "count", "index",
    "join", "split", "rsplit", "strip", "lstrip", "rstrip", "format",
    "startswith", "endswith", "encode", "decode", "lower", "upper",
    "replace", "find", "rfind", "title", "ljust", "rjust", "zfill",
    "read", "write", "close", "flush", "seek", "tell", "readline",
    "readlines", "open",
    "acquire", "release", "locked", "wait", "wait_for", "notify",
    "notify_all", "set", "is_set", "start", "run", "is_alive",
    "result", "exception", "done", "cancel", "submit", "shutdown",
    "get_nowait", "put_nowait", "qsize", "empty", "full", "task_done",
    "match", "search", "findall", "finditer", "sub", "group", "groups",
    "end", "span",
    "astype", "tolist", "item", "reshape", "ravel", "flatten",
    "squeeze", "sum", "min", "max", "mean", "std", "any", "all",
    "nonzero", "cumsum", "argsort", "take", "dot", "view", "fill",
})

# receivers that name a library module, never a repo object: a call on
# one resolves to nothing (``np.save`` / ``np.load`` would otherwise
# resolve by unique name to ``checkpoint.checkpoint.save`` /
# ``kernels._build.load``; a departure from the JAX package, whose tree
# calls neither under a lock)
_LIBRARY_MODULES = ("np", "numpy", "torch")

# resolution fan-out cap for name-based fallback: more candidates than
# this means the name is too generic to trust
_MAX_FANOUT = 6

# (lock-node glob, blocking-kind glob, reason).  Waived findings are
# reported in the text output — the escape hatch is visible, not silent.
BLOCKING_WAIVERS = (
    ("serving.join_service.PlanLibrary.lease.*", "*",
     "per-key planning lease is *designed* to be held across plan_join "
     "(oracle labeling + engine pulls): racing cold plans serialize so "
     "the loser wakes to a library hit — DESIGN.md §8a"),
    ("engine.sharded._HOST_MESH_LOCK", "dist.new_group",
     "the host mesh is created once per world under this lock: new_group "
     "must be issued by every rank the same number of times in the same "
     "order, so two threads of one rank that both created the mesh would "
     "issue it twice here and once elsewhere; later calls are dict hits, "
     "and at world 1 no group is created.  No fleet worker reaches it on "
     "a world > 1: JoinFleet.__init__ resolves its mesh (the store's, or "
     "this one) on every rank before any worker starts, and hands it to "
     "every tenant's sharded engine through engine_opts"),
)

# blocking-call surface: call name -> kind, with receiver constraints
# applied in _blocking_kind below
_QUEUE_TYPES = ("Queue", "SimpleQueue", "LifoQueue", "PriorityQueue")
# host syncs of a device tensor (the port's counterparts of
# jax.device_get): each waits for the tensor's producing kernels
_HOST_PULLS = ("cpu", "numpy", "item", "tolist")
# torch.distributed calls that block until the other ranks take part
_DIST_BLOCKING = frozenset({
    "new_group", "new_subgroups", "init_process_group", "barrier",
    "monitored_barrier", "all_reduce", "all_gather",
    "all_gather_into_tensor", "all_gather_object", "broadcast",
    "broadcast_object_list", "send", "recv", "send_object_list",
    "recv_object_list", "all_to_all", "all_to_all_single", "gather",
    "gather_object", "scatter", "scatter_object_list", "reduce",
    "reduce_scatter", "reduce_scatter_tensor",
})
_DIST_RECEIVERS = ("dist", "torch.distributed", "distributed")


@dataclasses.dataclass(frozen=True)
class LockNode:
    name: str                      # e.g. "serving.planes.FeaturePlaneStore._lock"
    kind: str                      # Lock | RLock | Condition
    file: str                      # repo-relative path
    line: int                      # construction line (witness map key)


class _CMRef:
    """A context-manager call held on the with-stack: resolved to the
    callee's locks-held-at-yield during edge generation."""
    __slots__ = ("call",)

    def __init__(self, call):
        self.call = call


@dataclasses.dataclass
class _Call:
    line: int
    held: tuple                    # entries: node name (str) | _CMRef
    name: str                      # method or function name
    is_method: bool
    recv_kind: str                 # self | name | attr | class | call | none
    recv_type: Optional[str]       # inferred class name, if any
    recv_name: str                 # textual receiver, for heuristics
    recv_lock: Optional[str]       # lock node of the receiver (cond.wait)


@dataclasses.dataclass
class _Acq:
    node: str
    line: int
    held: tuple


@dataclasses.dataclass
class _Func:
    qual: str                      # "mod.Class.method" | "mod.func[.nested]"
    mod: str
    cls: Optional[str]
    name: str
    file: str
    line: int
    is_cm: bool = False
    nested: bool = False           # defined inside another function
    acqs: list = dataclasses.field(default_factory=list)
    calls: list = dataclasses.field(default_factory=list)
    yield_helds: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _ClassRec:
    mod: str
    bases: list
    methods: dict                  # name -> _Func
    lock_attrs: dict               # attr -> node name
    attr_types: dict               # attr -> class-name string


@dataclasses.dataclass
class LockGraph:
    nodes: dict                    # name -> LockNode
    edges: dict                    # (held, acquired) -> [site strings]
    findings: list                 # [Finding]
    waived: list                   # [str] — waived blocking reports

    def edge_set(self) -> set:
        return set(self.edges)


def _lock_ctor_kind(e) -> Optional[str]:
    """'Lock'|'RLock'|'Condition' if ``e`` is ``threading.X()``."""
    if not isinstance(e, ast.Call):
        return None
    f = e.func
    if (isinstance(f, ast.Attribute) and f.attr in _LOCK_CTORS
            and isinstance(f.value, ast.Name) and f.value.id == "threading"):
        return f.attr
    return None


def _ann_type(a) -> Optional[str]:
    """Best-effort class name out of an annotation node: unwraps
    Optional[X], Union[X, None], X | None, "X" string forms."""
    if a is None:
        return None
    if isinstance(a, ast.Constant) and isinstance(a.value, str):
        try:
            a = ast.parse(a.value, mode="eval").body
        except SyntaxError:
            return None
    if isinstance(a, ast.Name):
        return a.id
    if isinstance(a, ast.Attribute):
        return a.attr
    if isinstance(a, ast.Subscript):           # Optional[X] / Union[...]
        inner = a.slice
        if isinstance(inner, ast.Tuple):
            for el in inner.elts:
                t = _ann_type(el)
                if t and t != "None":
                    return t
            return None
        return _ann_type(inner)
    if isinstance(a, ast.BinOp) and isinstance(a.op, ast.BitOr):
        return _ann_type(a.left) or _ann_type(a.right)
    return None


def _ctor_type(e) -> Optional[str]:
    """Class name if ``e`` constructs one: ``C(...)``, ``mod.C(...)``,
    ``x or C(...)`` (class names are CapWords by repo convention)."""
    if isinstance(e, ast.Call):
        f = e.func
        name = f.id if isinstance(f, ast.Name) else (
            f.attr if isinstance(f, ast.Attribute) else None)
        if name and name[:1].isupper():
            return name
        return None
    if isinstance(e, ast.BoolOp) and isinstance(e.op, ast.Or):
        for v in e.values:
            t = _ctor_type(v)
            if t:
                return t
    return None


class _ModuleScan:
    """Per-module AST pass: lock nodes, class/type tables, and a
    held-stack walk of every function body."""

    def __init__(self, path: str, source: str):
        self.path = path
        self.mod = module_name(path)
        self.tree = ast.parse(source, filename=path)
        self.nodes: dict = {}              # node name -> LockNode
        self.classes: dict = {}            # class name -> _ClassRec
        self.module_locks: dict = {}       # bare name -> node name
        self.funcs: list = []              # [_Func]
        self._scan_toplevel()
        self._scan_attr_tables()
        self._scan_functions()

    # -- discovery -----------------------------------------------------------

    def _add_node(self, name: str, kind: str, line: int) -> str:
        if name not in self.nodes:
            self.nodes[name] = LockNode(name, kind, self.path, line)
        return name

    def _scan_toplevel(self) -> None:
        for st in self.tree.body:
            if isinstance(st, ast.Assign) and len(st.targets) == 1 \
                    and isinstance(st.targets[0], ast.Name):
                kind = _lock_ctor_kind(st.value)
                if kind:
                    n = st.targets[0].id
                    self.module_locks[n] = self._add_node(
                        f"{self.mod}.{n}", kind, st.lineno)
            elif isinstance(st, ast.ClassDef):
                bases = [b.id if isinstance(b, ast.Name) else
                         (b.attr if isinstance(b, ast.Attribute) else None)
                         for b in st.bases]
                rec = _ClassRec(self.mod, [b for b in bases if b], {}, {}, {})
                self.classes[st.name] = rec
                for s in st.body:              # class-level locks
                    if isinstance(s, ast.Assign) and len(s.targets) == 1 \
                            and isinstance(s.targets[0], ast.Name):
                        kind = _lock_ctor_kind(s.value)
                        if kind:
                            attr = s.targets[0].id
                            rec.lock_attrs[attr] = self._add_node(
                                f"{self.mod}.{st.name}.{attr}", kind,
                                s.lineno)

    def _scan_attr_tables(self) -> None:
        """``self.X = ...`` across every method: lock attrs + attr types."""
        for cname, rec in self.classes.items():
            cdef = next(st for st in self.tree.body
                        if isinstance(st, ast.ClassDef) and st.name == cname)
            for m in cdef.body:
                if not isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                params = self._param_types(m)
                for node in ast.walk(m):
                    tgt = val = None
                    if isinstance(node, ast.Assign) \
                            and len(node.targets) == 1:
                        tgt, val = node.targets[0], node.value
                    elif isinstance(node, ast.AnnAssign):
                        tgt, val = node.target, node.value
                    if not (isinstance(tgt, ast.Attribute)
                            and isinstance(tgt.value, ast.Name)
                            and tgt.value.id == "self"):
                        continue
                    attr = tgt.attr
                    kind = _lock_ctor_kind(val)
                    if kind:
                        rec.lock_attrs.setdefault(attr, self._add_node(
                            f"{self.mod}.{cname}.{attr}", kind, node.lineno))
                        continue
                    t = _ctor_type(val) if val is not None else None
                    if t is None and isinstance(node, ast.AnnAssign):
                        t = _ann_type(node.annotation)
                    if t is None and isinstance(val, ast.Name):
                        t = params.get(val.id)
                    if t:
                        rec.attr_types.setdefault(attr, t)

    @staticmethod
    def _param_types(fn) -> dict:
        out = {}
        args = list(fn.args.posonlyargs) + list(fn.args.args) \
            + list(fn.args.kwonlyargs)
        for a in args:
            t = _ann_type(a.annotation)
            if t:
                out[a.arg] = t
        return out

    # -- function walk -------------------------------------------------------

    def _scan_functions(self) -> None:
        for st in self.tree.body:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._scan_one(st, f"{self.mod}.{st.name}", None, {})
            elif isinstance(st, ast.ClassDef):
                for m in st.body:
                    if isinstance(m, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                        self._scan_one(m, f"{self.mod}.{st.name}.{m.name}",
                                       st.name, {})

    def _scan_one(self, fn, qual: str, cls: Optional[str],
                  outer_types: dict, nested: bool = False) -> None:
        f = _Func(qual=qual, mod=self.mod, cls=cls, name=fn.name,
                  file=self.path, line=fn.lineno,
                  is_cm=any(self._is_cm_decorator(d)
                            for d in fn.decorator_list),
                  nested=nested)
        walker = _FuncWalker(self, f, cls, dict(outer_types))
        walker.types.update(self._param_types(fn))
        walker.walk_body(fn.body)
        self.funcs.append(f)
        for inner in walker.nested:
            self._scan_one(inner, f"{qual}.{inner.name}", cls,
                           walker.types, nested=True)

    @staticmethod
    def _is_cm_decorator(d) -> bool:
        name = d.attr if isinstance(d, ast.Attribute) else (
            d.id if isinstance(d, ast.Name) else None)
        return name == "contextmanager"


class _FuncWalker:
    """Held-stack interpretation of one function body."""

    def __init__(self, mod: _ModuleScan, func: _Func, cls: Optional[str],
                 types: dict):
        self.mod = mod
        self.func = func
        self.cls = cls
        self.types = types             # local/param name -> class name
        self.local_locks: dict = {}    # local name -> node name
        self.held: list = []           # node names / _CMRef, innermost last
        self.nested: list = []         # nested FunctionDefs, scanned after
        self.call_by_ast: dict = {}    # id(ast.Call) -> _Call

    # -- lock expression resolution -----------------------------------------

    def _lock_node_of(self, e) -> Optional[str]:
        if isinstance(e, ast.Attribute) and isinstance(e.value, ast.Name):
            base, attr = e.value.id, e.attr
            if base == "self" and self.cls:
                rec = self.mod.classes.get(self.cls)
                if rec and attr in rec.lock_attrs:
                    return rec.lock_attrs[attr]
            rec = self.mod.classes.get(base)
            if rec and attr in rec.lock_attrs:  # ClassName._class_lock
                return rec.lock_attrs[attr]
        elif isinstance(e, ast.Name):
            return self.local_locks.get(e.id) \
                or self.mod.module_locks.get(e.id)
        return None

    # -- statement walk ------------------------------------------------------

    def walk_body(self, stmts) -> None:
        for st in stmts:
            self.walk_stmt(st)

    def walk_stmt(self, st) -> None:
        if isinstance(st, (ast.With, ast.AsyncWith)):
            self._handle_with(st)
        elif isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self.nested.append(st)
        elif isinstance(st, ast.ClassDef):
            pass
        elif isinstance(st, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            self._handle_assign(st)
        else:
            for ch in ast.iter_child_nodes(st):
                if isinstance(ch, ast.stmt):
                    self.walk_stmt(ch)
                elif isinstance(ch, ast.expr):
                    self.walk_expr(ch)

    def _handle_with(self, w) -> None:
        pushed = 0
        for item in w.items:
            ce = item.context_expr
            node = self._lock_node_of(ce)
            if node is not None:
                self.func.acqs.append(
                    _Acq(node, ce.lineno, tuple(self.held)))
                self.held.append(node)
                pushed += 1
                continue
            self.walk_expr(ce)
            for cn in self._context_calls(ce):
                rec = self.call_by_ast.get(id(cn))
                if rec is not None:
                    self.held.append(_CMRef(rec))
                    pushed += 1
        self.walk_body(w.body)
        del self.held[len(self.held) - pushed:]

    @staticmethod
    def _context_calls(e) -> list:
        """Top-level Call nodes of a with-item context expression
        (through IfExp branches / BoolOp alternatives)."""
        if isinstance(e, ast.Call):
            return [e]
        if isinstance(e, ast.IfExp):
            return (_FuncWalker._context_calls(e.body)
                    + _FuncWalker._context_calls(e.orelse))
        if isinstance(e, ast.BoolOp):
            out = []
            for v in e.values:
                out.extend(_FuncWalker._context_calls(v))
            return out
        return []

    def _handle_assign(self, st) -> None:
        tgt = None
        if isinstance(st, ast.Assign) and len(st.targets) == 1:
            tgt = st.targets[0]
        elif isinstance(st, (ast.AnnAssign, ast.AugAssign)):
            tgt = st.target
        val = st.value
        if val is None:
            return
        kind = _lock_ctor_kind(val)
        if kind and isinstance(tgt, ast.Name):
            # lk = threading.Lock() — a function-local lock (lease locks)
            node = self.mod._add_node(
                f"{self.func.qual}.{tgt.id}", kind, val.lineno)
            self.local_locks[tgt.id] = node
            return
        if kind and isinstance(tgt, ast.Attribute):
            return                         # self.X: pre-scanned attr table
        # a lock constructed *inside* the value (setdefault, containers)
        embedded = next((n for n in ast.walk(val)
                         if _lock_ctor_kind(n)), None)
        if embedded is not None:
            node = self.mod._add_node(
                f"{self.func.qual}.@{embedded.lineno}",
                _lock_ctor_kind(embedded), embedded.lineno)
            if isinstance(tgt, ast.Name) and isinstance(val, ast.Call):
                # lk = d.setdefault(k, threading.Lock()): result IS the lock
                self.local_locks[tgt.id] = node
        self.walk_expr(val)
        if isinstance(tgt, ast.Name):
            t = _ctor_type(val)
            if t is None and isinstance(st, ast.AnnAssign):
                t = _ann_type(st.annotation)
            if t is None and isinstance(val, ast.Attribute) \
                    and isinstance(val.value, ast.Name) \
                    and val.value.id == "self" and self.cls:
                rec = self.mod.classes.get(self.cls)
                t = rec.attr_types.get(val.attr) if rec else None
            if t is None and isinstance(val, ast.Name):
                t = self.types.get(val.id)
            if t:
                self.types[tgt.id] = t

    # -- expression walk -----------------------------------------------------

    def walk_expr(self, e) -> None:
        if e is None:
            return
        if isinstance(e, ast.Lambda):
            return                         # body runs later, elsewhere
        if isinstance(e, (ast.Yield, ast.YieldFrom)):
            self.func.yield_helds.append(tuple(self.held))
            if getattr(e, "value", None) is not None:
                self.walk_expr(e.value)
            return
        if isinstance(e, ast.Call):
            self._record_call(e)
            for ch in ast.iter_child_nodes(e):
                if isinstance(ch, ast.expr) and ch is not e.func:
                    self.walk_expr(ch)
                elif isinstance(ch, ast.keyword):
                    self.walk_expr(ch.value)
            if isinstance(e.func, ast.Attribute):
                self.walk_expr(e.func.value)
            return
        for ch in ast.iter_child_nodes(e):
            if isinstance(ch, ast.expr):
                self.walk_expr(ch)
            elif isinstance(ch, ast.keyword):
                self.walk_expr(ch.value)
            elif isinstance(ch, ast.comprehension):
                self.walk_expr(ch.iter)
                for cond in ch.ifs:
                    self.walk_expr(cond)

    def _record_call(self, e: ast.Call) -> None:
        f = e.func
        rec = None
        if isinstance(f, ast.Attribute):
            name = f.attr
            r = f.value
            recv_kind, recv_type, recv_name = "attr", None, ""
            if isinstance(r, ast.Name):
                recv_name = r.id
                if r.id == "self":
                    recv_kind = "self"
                elif r.id in self.mod.classes:
                    recv_kind, recv_type = "class", r.id
                elif r.id in _LIBRARY_MODULES:
                    recv_kind, recv_type = "name", f"module {r.id}"
                else:
                    recv_kind = "name"
                    recv_type = self.types.get(r.id)
            elif isinstance(r, ast.Attribute) \
                    and isinstance(r.value, ast.Name) \
                    and r.value.id == "self":
                recv_name = f"self.{r.attr}"
                crec = self.mod.classes.get(self.cls) if self.cls else None
                recv_type = crec.attr_types.get(r.attr) if crec else None
            elif isinstance(r, ast.Attribute):
                recv_name = _dotted(r)     # torch.cuda, torch.distributed
            elif isinstance(r, ast.Call):
                recv_kind = "call"
                cf = r.func
                cname = cf.id if isinstance(cf, ast.Name) else (
                    cf.attr if isinstance(cf, ast.Attribute) else "")
                recv_name = f"{cname}()"
                if cname == "current_tracer":
                    recv_type = "Tracer"
                elif cname[:1].isupper():
                    recv_type = cname
            rec = _Call(e.lineno, tuple(self.held), name, True,
                        recv_kind, recv_type, recv_name,
                        self._lock_node_of(r))
            if name == "acquire":
                node = self._lock_node_of(r)
                if node is not None:
                    self.func.acqs.append(
                        _Acq(node, e.lineno, tuple(self.held)))
                    self.held.append(node)  # held to end of function scope
            elif name == "release":
                node = self._lock_node_of(r)
                if node is not None and node in self.held:
                    # drop the innermost occurrence
                    for i in range(len(self.held) - 1, -1, -1):
                        if self.held[i] == node:
                            del self.held[i]
                            break
        elif isinstance(f, ast.Name):
            rec = _Call(e.lineno, tuple(self.held), f.id, False,
                        "none", None, "", None)
        if rec is not None:
            self.func.calls.append(rec)
            self.call_by_ast[id(e)] = rec


# ---------------------------------------------------------------------------
# Graph assembly: call resolution, fixpoints, edges, checks
# ---------------------------------------------------------------------------

class _GraphBuilder:
    def __init__(self, scans: list):
        self.scans = scans
        self.nodes: dict = {}
        self.classes: dict = {}            # simple class name -> _ClassRec
        self.class_mod: dict = {}
        self.funcs: dict = {}              # qual -> _Func
        self.methods_by_name: dict = {}
        self.functions_by_name: dict = {}
        self.node_kind: dict = {}
        for s in scans:
            self.nodes.update(s.nodes)
            for cname, rec in s.classes.items():
                self.classes.setdefault(cname, rec)
            for f in s.funcs:
                self.funcs[f.qual] = f
                if f.cls and not f.nested:
                    rec = s.classes[f.cls]
                    rec.methods.setdefault(f.name, f)
                    self.methods_by_name.setdefault(f.name, []).append(f)
                else:
                    # nested closures resolve like plain functions: a
                    # method-local ``def build()`` is called by bare name
                    self.functions_by_name.setdefault(
                        f.name, []).append(f)
        self.node_kind = {n: ln.kind for n, ln in self.nodes.items()}
        self._resolve_cache: dict = {}

    # -- call resolution -----------------------------------------------------

    def resolve(self, c: _Call, ctx_cls: Optional[str]) -> list:
        key = (id(c), ctx_cls)
        hit = self._resolve_cache.get(key)
        if hit is not None:
            return hit
        out = self._resolve_uncached(c, ctx_cls)
        self._resolve_cache[key] = out
        return out

    def _method_on(self, cls: Optional[str], name: str,
                   depth: int = 0) -> Optional[_Func]:
        if cls is None or depth > 4:
            return None
        rec = self.classes.get(cls)
        if rec is None:
            return None
        m = rec.methods.get(name)
        if m is not None:
            return m
        for b in rec.bases:
            m = self._method_on(b, name, depth + 1)
            if m is not None:
                return m
        return None

    def _resolve_uncached(self, c: _Call, ctx_cls: Optional[str]) -> list:
        if c.is_method:
            if c.recv_kind == "self":
                m = self._method_on(ctx_cls, c.name)
                if m is not None:
                    return [m]
            elif c.recv_type is not None:
                m = self._method_on(c.recv_type, c.name)
                if m is not None:
                    return [m]
                if c.recv_type not in self.classes:
                    # typed with a non-repo class (Queue, ndarray...):
                    # never fall through to name matching
                    return []
            if c.name in _NAME_DENYLIST:
                return []
            cands = (self.methods_by_name.get(c.name, [])
                     + self.functions_by_name.get(c.name, []))
            return cands if 0 < len(cands) <= _MAX_FANOUT else []
        # plain-name call: constructor or function
        rec = self.classes.get(c.name)
        if rec is not None:
            init = self._method_on(c.name, "__init__")
            return [init] if init is not None else []
        cands = self.functions_by_name.get(c.name, [])
        return cands if 0 < len(cands) <= _MAX_FANOUT else []

    # -- fixpoints -----------------------------------------------------------

    def may_acquire(self) -> dict:
        may = {q: {a.node for a in f.acqs} for q, f in self.funcs.items()}
        changed = True
        while changed:
            changed = False
            for q, f in self.funcs.items():
                s = may[q]
                before = len(s)
                for c in f.calls:
                    for g in self.resolve(c, f.cls):
                        s |= may[g.qual]
                if len(s) != before:
                    changed = True
        return may

    def may_block(self) -> dict:
        """qual -> {kind: (example line, call-chain tuple)} — transitively
        reachable blocking calls (Condition.wait stays direct-site only:
        waiting under its own condition is the normal pattern)."""
        mayb: dict = {}
        for q, f in self.funcs.items():
            d = {}
            for c in f.calls:
                kind = _blocking_kind(c)
                if kind and kind != "Condition.wait":
                    d.setdefault(kind, (c.line, (q,)))
            mayb[q] = d
        changed = True
        while changed:
            changed = False
            for q, f in self.funcs.items():
                d = mayb[q]
                for c in f.calls:
                    for g in self.resolve(c, f.cls):
                        for kind, (_, chain) in mayb[g.qual].items():
                            if kind not in d and len(chain) < 8:
                                d[kind] = (c.line, (q,) + chain)
                                changed = True
        return mayb

    # -- held-stack expansion ------------------------------------------------

    def expand_held(self, held: tuple, ctx_cls: Optional[str],
                    _depth: int = 0) -> list:
        out: list = []
        for h in held:
            if isinstance(h, str):
                if h not in out:
                    out.append(h)
            elif isinstance(h, _CMRef) and _depth < 4:
                for g in self.resolve(h.call, ctx_cls):
                    if not g.is_cm:
                        continue
                    for yh in g.yield_helds:
                        for n in self.expand_held(yh, g.cls, _depth + 1):
                            if n not in out:
                                out.append(n)
        return out


def _dotted(e) -> str:
    """``a.b.c`` for a chain of attributes on a name, else ''."""
    parts = []
    while isinstance(e, ast.Attribute):
        parts.append(e.attr)
        e = e.value
    if not isinstance(e, ast.Name):
        return ""
    return ".".join([e.id] + parts[::-1])


def _blocking_kind(c: _Call) -> Optional[str]:
    if c.name == "label_pairs":
        return "oracle.label_pairs"
    if not c.is_method:
        return None
    if c.name == "synchronize":
        if c.recv_name in ("torch.cuda", "cuda"):
            return "torch.cuda.synchronize"
        if c.recv_type == "Stream" or "stream" in c.recv_name.lower():
            return "Stream.synchronize"
        return "Event.synchronize"
    if c.name in _HOST_PULLS:
        return f"tensor.{c.name}"
    if c.name in _DIST_BLOCKING and c.recv_name in _DIST_RECEIVERS:
        return f"dist.{c.name}"
    if c.name == "result":
        return "Future.result"
    if c.name == "sleep" and c.recv_name == "time":
        return "time.sleep"
    if c.name in ("put", "get") and (
            c.recv_type in _QUEUE_TYPES
            or c.recv_name in ("q", "queue")
            or c.recv_name.endswith((".q", "._q", ".queue"))):
        return f"queue.{c.name}"
    if c.name == "wait":
        return "Condition.wait"
    if c.name == "join" and (
            c.recv_type == "Thread"
            or "thread" in c.recv_name.lower()
            or "worker" in c.recv_name.lower()):
        return "Thread.join"
    return None


def _waiver_for(lock: str, kind: str) -> Optional[str]:
    for pat_lock, pat_kind, reason in BLOCKING_WAIVERS:
        if fnmatch.fnmatch(lock, pat_lock) and fnmatch.fnmatch(kind,
                                                               pat_kind):
            return reason
    return None


def build_lock_graph(sources: Optional[list] = None) -> LockGraph:
    """Analyze ``(path, source)`` pairs (default: the src/repro_torch
    tree)."""
    if sources is None:
        sources = iter_py_sources("src/repro_torch")
    scans = [_ModuleScan(p, s) for p, s in sources]
    b = _GraphBuilder(scans)
    may = b.may_acquire()
    mayb = b.may_block()

    edges: dict = {}
    findings: list = []
    waived: list = []

    def edge(h: str, a: str, site: str) -> None:
        sites = edges.setdefault((h, a), [])
        if len(sites) < 4 and site not in sites:
            sites.append(site)

    for f in b.funcs.values():
        for acq in f.acqs:
            for h in b.expand_held(acq.held, f.cls):
                edge(h, acq.node, f"{f.file}:{acq.line}")
        for c in f.calls:
            held = b.expand_held(c.held, f.cls)
            if not held:
                continue
            callees = b.resolve(c, f.cls)
            for g in callees:
                for a in may[g.qual]:
                    for h in held:
                        edge(h, a, f"{f.file}:{c.line} via {g.qual}")
            # blocking under a held lock: direct + transitive
            kinds: dict = {}
            direct = _blocking_kind(c)
            if direct:
                kinds[direct] = (c.line, (f.qual,))
            for g in callees:
                for kind, (_, chain) in mayb[g.qual].items():
                    kinds.setdefault(kind, (c.line, (f.qual,) + chain))
            for kind, (line, chain) in kinds.items():
                blockers = held
                if kind == "Condition.wait" and c.recv_lock is not None:
                    blockers = [h for h in held if h != c.recv_lock]
                for h in blockers:
                    reason = _waiver_for(h, kind)
                    via = " -> ".join(chain)
                    if reason is not None:
                        waived.append(
                            f"{f.file}:{line}: {kind} under {h} "
                            f"(via {via}) — waived: {reason}")
                    else:
                        findings.append(Finding(
                            "lock-blocking", f.file, line,
                            f"blocking call {kind} reached while holding "
                            f"{h} (path: {via})"))

    # self-acquisition on a non-reentrant Lock is a guaranteed deadlock
    for (h, a), sites in sorted(edges.items()):
        if h == a and b.node_kind.get(h) == "Lock":
            findings.append(Finding(
                "lock-self-deadlock", b.nodes[h].file, b.nodes[h].line,
                f"non-reentrant Lock {h} may be re-acquired while held "
                f"(sites: {', '.join(sites)})"))

    for cyc in _cycles(edges, b.node_kind):
        ring = " -> ".join(cyc + [cyc[0]])
        first = b.nodes.get(cyc[0])
        findings.append(Finding(
            "lock-cycle", first.file if first else "?",
            first.line if first else 0,
            f"lock-order cycle (potential deadlock): {ring}"))

    return LockGraph(nodes=b.nodes, edges=edges, findings=findings,
                     waived=waived)


def _cycles(edges: dict, kinds: dict) -> list:
    """Cycles among *distinct* nodes (Tarjan SCCs of size > 1; reentrant
    self-loops are legal and handled separately)."""
    adj: dict = {}
    for (h, a) in edges:
        if h != a:
            adj.setdefault(h, set()).add(a)
            adj.setdefault(a, set())
    index: dict = {}
    low: dict = {}
    on: set = set()
    stack: list = []
    out: list = []
    counter = [0]

    def strong(v):
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on.add(v)
        for w in sorted(adj.get(v, ())):
            if w not in index:
                strong(w)
                low[v] = min(low[v], low[w])
            elif w in on:
                low[v] = min(low[v], index[w])
        if low[v] == index[v]:
            comp = []
            while True:
                w = stack.pop()
                on.discard(w)
                comp.append(w)
                if w == v:
                    break
            if len(comp) > 1:
                out.append(sorted(comp))

    for v in sorted(adj):
        if v not in index:
            strong(v)
    return out


# ---------------------------------------------------------------------------
# Rendering
# ---------------------------------------------------------------------------

def to_dot(g: LockGraph) -> str:
    """Graphviz DOT of the lock-order graph."""
    lines = ["digraph lock_order {",
             '  rankdir=LR; node [shape=box, fontsize=10];']
    used = {n for e in g.edges for n in e}
    for name in sorted(g.nodes):
        ln = g.nodes[name]
        if name not in used:
            continue
        style = {"RLock": "rounded", "Condition": "diagonals"}.get(
            ln.kind, "solid")
        lines.append(
            f'  "{name}" [label="{name}\\n{ln.kind} {ln.file}:{ln.line}",'
            f' style="{style}"];')
    for (h, a), sites in sorted(g.edges.items()):
        attr = ' [style=dashed]' if h == a else ''
        lines.append(f'  "{h}" -> "{a}"'
                     f' [tooltip="{sites[0]}"]{attr};' if h != a else
                     f'  "{h}" -> "{a}"{attr};')
    lines.append("}")
    return "\n".join(lines) + "\n"


def render_text(g: LockGraph) -> str:
    out = [f"lock nodes: {len(g.nodes)}   order edges: {len(g.edges)}"]
    for (h, a), sites in sorted(g.edges.items()):
        loop = "   (reentrant self-loop)" if h == a else ""
        out.append(f"  {h} -> {a}{loop}")
        out.append(f"      e.g. {sites[0]}")
    if g.waived:
        out.append("waived blocking holds (explicit, see "
                   "lockgraph.BLOCKING_WAIVERS):")
        for w in g.waived:
            out.append(f"  {w}")
    if g.findings:
        out.append("FINDINGS:")
        for f in g.findings:
            out.append(f"  {f}")
    else:
        out.append("no lock-order or blocking violations")
    return "\n".join(out) + "\n"
