"""Concurrency family, static half: whole-program thread-safety analysis.

Counterpart of ``maskclustering_tpu/analysis/concurrency.py`` over the
port. The port runs many threads: scene prefetch daemons and the
overlapped executor's host tail (``utils/daemon_future.DaemonFuture``),
watchdog deadline threads (``utils/faults.call_with_deadline``), the
SIGTERM handler, the serving daemon's acceptor, connection, worker and
pruner threads, the supervisor's pipe readers and pumps, the subprocess
worker's heartbeat emitter, the pool's scheduler, the telemetry ticker and
the canary sentinel, over the lock-guarded obs sinks. This module makes
their thread safety a machine-checked contract.

**Thread-topology model.** Thread roots are collected tree-wide: targets
of ``DaemonFuture(fn)`` / ``threading.Thread(target=fn)`` / executor
``.submit(fn)`` / ``.map(fn)``, functions registered as signal handlers
(``signal.signal(SIG, fn)``), ``faults.call_with_deadline(fn, ...)``
watchdog targets, the cross-module ``THREAD_ENTRY_HINTS``, and any
function whose ``def`` line carries a ``# mct-thread: root`` marker.
Reachability closes over the module-local call graph per root, so shared
state can be attributed to the SET of roots that can touch it.

**Marker grammar** (``# mct-thread:`` — role annotations the AST alone
cannot derive)::

    # mct-thread: root                  this def is a thread entry the
                                        collector cannot see (dispatched
                                        through a registry / first-class
                                        callable)
    # mct-thread: abandon(<rationale>)  this Thread spawn is deliberately
                                        never joined (the daemon-
                                        abandonment pattern); the
                                        rationale is REQUIRED
    # mct-thread: immutable             this module-level binding is
                                        never mutated after import

**Checks** (inline opt-out: ``# mct-ok: <CHECK>``, shared with the ast
family):

- **CONC.SHARED** — a module-level mutable reachable from >= 2 roots is
  mutated without a lock and is neither queue-typed (``deque`` /
  ``queue.Queue``: GIL-atomic mutators) nor marked immutable. The
  whole-program generalization of AST.THREADS (which stays: it fires on
  single-root mutation too: the unlocked-registry pattern).
- **CONC.LOCKORDER** — the global lock-order graph (every ``with lock:``
  body's nested acquisitions, closed over module-local calls and the
  known cross-module acquirers) must be acyclic. Nodes are the canonical
  lock ids — ``mct_lock``'s literal name when present, ``file:qualname``
  otherwise — one vocabulary with the runtime sanitizer.
- **CONC.BLOCKING** — no blocking call inside a ``with lock:`` body:
  device syncs (``np.asarray``, ``.item()``, ``.cpu()``, ``.tolist()``,
  ``.numpy()``, ``torch.cuda.synchronize``),
  file IO (``open``/``.write``/``.flush``/``.read*``, ``np.load/save``,
  ``json.dump/load``), ``time.sleep``, ``subprocess.*`` / ``os.system``,
  ``.result()`` / ``.join()`` / ``.wait()``, and acquiring a second lock
  (the order edge is additionally recorded for CONC.LOCKORDER).
- **CONC.SIGNAL** — a signal handler (transitively, module-local) may
  touch only ``threading.Event``/flag state: ``.set()``/``.is_set()``/
  ``.clear()``, ``os._exit``/``os.kill``, and plain assignments.
  Anything else — logging, IO, allocation-heavy helpers — is flagged
  (one aggregate finding per handler), because the handler can interrupt
  its own thread mid-anything.
- **CONC.JOIN** — every ``threading.Thread`` spawn is either joined with
  a bounded ``.join(timeout)`` in the same scope or carries an
  ``abandon(<rationale>)`` marker. ``with ThreadPoolExecutor(...)`` joins
  at block exit and needs nothing.
- **CONC.RESULT** — ``.result()`` with no timeout anywhere in the tree:
  an unbounded block on another thread's completion is exactly the wedge
  the watchdogs exist to prevent.

Pure stdlib, no torch import — the family runs in the same sub-second
budget as the ast family.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from maskclustering_tpu_torch.analysis.ast_checks import (
    SCAN_ROOTS,
    THREAD_ENTRY_HINTS,
    _attr_chain,
    _call_graph,
    _collect_functions,
    _is_lock_guard,
    _iter_py_files,
    _line_optout,
    _module_level_mutables,
    _MUTATOR_METHODS,
    _reachable,
    collect_thread_targets,
)
from maskclustering_tpu_torch.analysis.findings import Finding, make_id

# ---------------------------------------------------------------------------
# the marker grammar
# ---------------------------------------------------------------------------

_MARKER_RE = re.compile(
    r"#\s*mct-thread:\s*(root|immutable|abandon)\s*(?:\(([^)]*)\))?")


def thread_markers(source_lines: Sequence[str]) -> Dict[int, Tuple[str, str]]:
    """lineno (1-based) -> (kind, argument) for every ``# mct-thread:``."""
    out: Dict[int, Tuple[str, str]] = {}
    for i, line in enumerate(source_lines, 1):
        m = _MARKER_RE.search(line)
        if m:
            out[i] = (m.group(1), (m.group(2) or "").strip())
    return out


def _marker_at(markers: Dict[int, Tuple[str, str]], node: ast.AST,
               kind: str) -> Optional[str]:
    """The marker argument when ``node``'s line carries ``kind``."""
    got = markers.get(getattr(node, "lineno", 0))
    if got and got[0] == kind:
        return got[1]
    return None


# ---------------------------------------------------------------------------
# lock identities (one vocabulary with lock_sanitizer.mct_lock)
# ---------------------------------------------------------------------------

_LOCK_CTORS = {"Lock", "RLock"}


def _lock_ctor_id(value: ast.AST, rel: str, attr: str,
                  cls: Optional[str]) -> Optional[str]:
    """Canonical id when ``value`` constructs a lock; None otherwise."""
    if not isinstance(value, ast.Call):
        return None
    chain = _attr_chain(value.func) or ""
    tail = chain.rsplit(".", 1)[-1]
    if tail == "mct_lock":
        if value.args and isinstance(value.args[0], ast.Constant) \
                and isinstance(value.args[0].value, str):
            return value.args[0].value  # the shared-vocabulary literal
        return f"{rel}:{cls + '.' if cls else ''}{attr}"
    if tail in _LOCK_CTORS and chain.split(".")[0] in ("threading", tail):
        return f"{rel}:{cls + '.' if cls else ''}{attr}"
    return None


def _collect_locks(tree: ast.Module, rel: str
                   ) -> Tuple[Dict[str, str], Dict[Tuple[str, str], str]]:
    """(module-level name -> id, (class, attr) -> id) for this module."""
    module_locks: Dict[str, str] = {}
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name):
            lid = _lock_ctor_id(stmt.value, rel, stmt.targets[0].id, None)
            if lid:
                module_locks[stmt.targets[0].id] = lid
    class_locks: Dict[Tuple[str, str], str] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        for sub in ast.walk(node):
            if isinstance(sub, ast.Assign) and len(sub.targets) == 1:
                t = sub.targets[0]
                if isinstance(t, ast.Attribute) \
                        and isinstance(t.value, ast.Name) \
                        and t.value.id == "self":
                    lid = _lock_ctor_id(sub.value, rel, t.attr, node.name)
                    if lid:
                        class_locks[(node.name, t.attr)] = lid
    return module_locks, class_locks


# cross-module functions known to acquire a named lock: attribute-call
# resolution cannot follow a bound method (`metrics.count` IS
# Registry.count), so the seams are declared. Over-approximation is safe:
# a static edge that never happens only widens the graph the runtime
# sanitizer must embed into.
_METRICS_LOCK = "obs.metrics.Registry._lock"
_EVENTS_LOCK = "obs.events.EventSink._lock"
# the port's obs calls, under each spelling its modules import them by
# (``obs.count``, ``metrics.count``, telemetry's ``_metrics.count``)
KNOWN_ACQUIRERS: Dict[str, str] = {
    f"{mod}.{fn}": _METRICS_LOCK
    for mod in ("metrics", "_metrics", "obs")
    for fn in ("count", "gauge", "gauge_max", "observe", "count_transfer")}
KNOWN_ACQUIRERS["obs.flush_metrics"] = _METRICS_LOCK
# suffix-matched acquirers (any EventSink handle: `self._sink.emit`, ...)
KNOWN_ACQUIRER_SUFFIXES: Tuple[Tuple[str, str], ...] = (
    ("_sink.emit", _EVENTS_LOCK),
    ("sink.emit", _EVENTS_LOCK),
)


class _ModuleInfo:
    """Everything the checkers need from one parsed file."""

    __slots__ = ("rel", "tree", "lines", "funcs", "graph", "fn_class",
                 "markers", "module_locks", "class_locks", "mutables",
                 "queue_typed", "immutable_marked")

    def __init__(self, rel: str, tree: ast.Module, lines: List[str]):
        self.rel = rel
        self.tree = tree
        self.lines = lines
        self.funcs = _collect_functions(tree)
        self.graph = _call_graph(self.funcs)  # shared by every checker
        self.fn_class = _function_classes(tree)
        self.markers = thread_markers(lines)
        self.module_locks, self.class_locks = _collect_locks(tree, rel)
        self.mutables = _module_level_mutables(tree)
        self.queue_typed = _queue_typed_globals(tree)
        self.immutable_marked = {
            t.id
            for stmt in tree.body if isinstance(stmt, (ast.Assign,
                                                       ast.AnnAssign))
            and _marker_at(self.markers, stmt, "immutable") is not None
            for t in (stmt.targets if isinstance(stmt, ast.Assign)
                      else [stmt.target])
            if isinstance(t, ast.Name)}


def _function_classes(tree: ast.Module) -> Dict[str, Optional[str]]:
    """function bare name -> enclosing class name (for self.X lock lookup).

    Last-def-wins, matching ``_collect_functions``'s approximation.
    """
    out: Dict[str, Optional[str]] = {}

    def visit(node: ast.AST, cls: Optional[str]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                visit(child, child.name)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out[child.name] = cls
                visit(child, cls)
            else:
                visit(child, cls)

    visit(tree, None)
    return out


_QUEUE_CTORS = {"deque", "Queue", "SimpleQueue", "LifoQueue",
                "PriorityQueue"}


def _queue_typed_globals(tree: ast.Module) -> Set[str]:
    """Module-level names bound to deque/Queue: their mutators are
    GIL-atomic (deque) or internally locked (queue.Queue) — the
    "queue-passed" leg of the shared-state contract."""
    out: Set[str] = set()
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign) and isinstance(stmt.value, ast.Call):
            chain = _attr_chain(stmt.value.func) or ""
            if chain.rsplit(".", 1)[-1] in _QUEUE_CTORS:
                out.update(t.id for t in stmt.targets
                           if isinstance(t, ast.Name))
    return out


def _resolve_lock(expr: ast.AST, mod: _ModuleInfo, cls: Optional[str],
                  tree_module_locks: Dict[str, str]
                  ) -> Tuple[Optional[str], bool]:
    """(canonical id | None, looks-like-a-lock) for a ``with`` item or
    ``.acquire()`` receiver. Resolution order: module-local name, same-
    class ``self.X``, tree-wide unique module-level name (the
    ``faults._PLAN_LOCK`` cross-module shape), then the ``"lock" in
    chain`` heuristic (held, but anonymous in the graph)."""
    target = expr
    if isinstance(expr, ast.Call):  # lock.acquire(...) / mct_lock misuse
        target = expr.func
        if isinstance(target, ast.Attribute) and target.attr == "acquire":
            target = target.value
    chain = _attr_chain(target)
    if chain is None:
        return None, False
    parts = chain.split(".")
    if len(parts) == 1 and parts[0] in mod.module_locks:
        return mod.module_locks[parts[0]], True
    if parts[0] == "self" and len(parts) == 2 and cls \
            and (cls, parts[1]) in mod.class_locks:
        return mod.class_locks[(cls, parts[1])], True
    if parts[-1] in tree_module_locks:
        return tree_module_locks[parts[-1]], True
    return None, "lock" in chain.lower()


# ---------------------------------------------------------------------------
# acquire sets (module-local fixpoint + known cross-module seams)
# ---------------------------------------------------------------------------


def _direct_acquires(mod: _ModuleInfo, tree_module_locks: Dict[str, str]
                     ) -> Dict[str, Set[str]]:
    out: Dict[str, Set[str]] = {}
    for name, node in mod.funcs.items():
        cls = mod.fn_class.get(name)
        acquired: Set[str] = set()
        for sub in ast.walk(node):
            if isinstance(sub, ast.With):
                for item in sub.items:
                    lid, is_lock = _resolve_lock(item.context_expr, mod, cls,
                                                 tree_module_locks)
                    if is_lock and lid:
                        acquired.add(lid)
            if isinstance(sub, ast.Call):
                chain = _attr_chain(sub.func) or ""
                if chain.endswith(".acquire"):
                    lid, is_lock = _resolve_lock(sub, mod, cls,
                                                 tree_module_locks)
                    if is_lock and lid:
                        acquired.add(lid)
                if chain in KNOWN_ACQUIRERS:
                    acquired.add(KNOWN_ACQUIRERS[chain])
                else:
                    for suffix, lid in KNOWN_ACQUIRER_SUFFIXES:
                        if chain.endswith(suffix):
                            acquired.add(lid)
        out[name] = acquired
    return out


def _acquire_fixpoint(mod: _ModuleInfo, direct: Dict[str, Set[str]]
                      ) -> Dict[str, Set[str]]:
    graph = mod.graph
    acq = {name: set(locks) for name, locks in direct.items()}
    changed = True
    while changed:
        changed = False
        for name, callees in graph.items():
            for callee in callees:
                extra = acq.get(callee, set()) - acq[name]
                if extra:
                    acq[name] |= extra
                    changed = True
    return acq


# ---------------------------------------------------------------------------
# CONC.BLOCKING + lock-order edge collection (one walk serves both)
# ---------------------------------------------------------------------------

# attribute tails that block the calling thread; receivers that are string
# constants (",".join) and the path-join chains are excluded below
_BLOCKING_ATTR_TAILS = {"write", "flush", "read", "readline", "readlines",
                        "result", "join", "wait", "item", "cpu", "tolist",
                        "numpy"}
_BLOCKING_CHAINS = {"np.asarray", "numpy.asarray", "torch.cuda.synchronize",
                    "time.sleep", "os.system", "np.load", "np.save",
                    "json.dump", "json.load"}
_SAFE_CHAIN_SUFFIXES = ("path.join",)


def _blocking_token(call: ast.Call) -> Optional[str]:
    chain = _attr_chain(call.func) or ""
    if chain in _BLOCKING_CHAINS:
        return chain
    if chain.startswith("subprocess."):
        return chain
    if isinstance(call.func, ast.Name) and call.func.id == "open":
        return "open"
    if isinstance(call.func, ast.Attribute) \
            and call.func.attr in _BLOCKING_ATTR_TAILS:
        if isinstance(call.func.value, ast.Constant):
            return None  # ", ".join(...) — string method, not a thread join
        if any(chain.endswith(s) for s in _SAFE_CHAIN_SUFFIXES):
            return None
        return f".{call.func.attr}"
    return None


class _LockWalkResult:
    __slots__ = ("findings", "edges")

    def __init__(self):
        self.findings: List[Finding] = []
        self.edges: Dict[Tuple[str, str], Tuple[str, int]] = {}  # -> (rel, line)


def _direct_blocking_tokens(mod: _ModuleInfo) -> Dict[str, Set[str]]:
    """function -> blocking tokens anywhere in its body (opt-out lines
    excluded so a sanctioned direct site never propagates to callers)."""
    out: Dict[str, Set[str]] = {}
    for name, node in mod.funcs.items():
        tokens: Set[str] = set()
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                token = _blocking_token(sub)
                if token is not None \
                        and not _line_optout(mod.lines, sub,
                                             "CONC.BLOCKING"):
                    tokens.add(token)
        out[name] = tokens
    return out


def _blocking_fixpoint(mod: _ModuleInfo) -> Dict[str, Set[str]]:
    """Transitive closure of ``_direct_blocking_tokens`` over the
    module-local call graph: calling a helper that blocks IS blocking —
    moving the IO into a function must not get it past the gate."""
    blk = _direct_blocking_tokens(mod)
    changed = True
    while changed:
        changed = False
        for name, callees in mod.graph.items():
            for callee in callees:
                extra = blk.get(callee, set()) - blk[name]
                if extra:
                    blk[name] |= extra
                    changed = True
    return blk


def _walk_locks(mod: _ModuleInfo, acq: Dict[str, Set[str]],
                blk: Dict[str, Set[str]],
                tree_module_locks: Dict[str, str],
                result: _LockWalkResult) -> None:
    """Per-function held-lock walk: blocking-call findings + order edges."""
    ordinals: Dict[Tuple[str, str], int] = {}

    def blocking_finding(fname: str, node: ast.AST, token: str,
                         held_name: str) -> None:
        if _line_optout(mod.lines, node, "CONC.BLOCKING"):
            return
        key = (fname, token)
        ordinals[key] = ordinals.get(key, 0) + 1
        result.findings.append(Finding(
            id=make_id("CONC.BLOCKING", mod.rel, fname, token,
                       ordinals[key]),
            check="CONC.BLOCKING", family="concurrency",
            message=f"{token} inside the `with {held_name}:` body of "
                    f"{fname} — a blocking call under a held lock stalls "
                    f"every thread contending for it",
            file=mod.rel, line=getattr(node, "lineno", 0)))

    def visit(node: ast.AST, fname: str, cls: Optional[str],
              held: List[Tuple[Optional[str], str]]) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # nested defs walk as their own entries
        if isinstance(node, ast.With):
            new_held = list(held)
            for item in node.items:
                lid, is_lock = _resolve_lock(item.context_expr, mod, cls,
                                             tree_module_locks)
                if not is_lock:
                    continue
                display = lid or (_attr_chain(item.context_expr) or "<lock>")
                for h_id, h_disp in new_held:
                    if lid and h_id and lid != h_id:
                        result.edges.setdefault(
                            (h_id, lid),
                            (mod.rel, getattr(item.context_expr, "lineno",
                                              0)))
                    blocking_finding(fname, item.context_expr,
                                     f"lock:{display}", h_disp)
                new_held.append((lid, display))
            for child in node.body:
                visit(child, fname, cls, new_held)
            return
        if held and isinstance(node, ast.Call):
            token = _blocking_token(node)
            if token is not None:
                blocking_finding(fname, node, token, held[-1][1])
            else:
                # a module-local / known cross-module call that acquires
                # another lock under this one: an order edge + a finding.
                # A module-local callee that (transitively) blocks is a
                # blocking call too — IO moved into a helper stays caught
                chain = _attr_chain(node.func) or ""
                inner: Set[str] = set()
                if isinstance(node.func, ast.Name):
                    inner = acq.get(node.func.id, set())
                    for token in sorted(blk.get(node.func.id, ())):
                        blocking_finding(fname, node,
                                         f"{token} via {node.func.id}",
                                         held[-1][1])
                elif chain in KNOWN_ACQUIRERS:
                    inner = {KNOWN_ACQUIRERS[chain]}
                else:
                    for suffix, lid in KNOWN_ACQUIRER_SUFFIXES:
                        if chain.endswith(suffix):
                            inner = {lid}
                for lid in sorted(inner):
                    for h_id, h_disp in held:
                        if h_id and lid != h_id:
                            result.edges.setdefault(
                                (h_id, lid),
                                (mod.rel, getattr(node, "lineno", 0)))
                            blocking_finding(fname, node,
                                             f"lock:{lid} (via "
                                             f"{chain or node.func.id})",
                                             h_disp)
        for child in ast.iter_child_nodes(node):
            visit(child, fname, cls, held)

    for fname, node in mod.funcs.items():
        cls = mod.fn_class.get(fname)
        for child in ast.iter_child_nodes(node):
            visit(child, fname, cls, [])


def _find_cycles(edges: Iterable[Tuple[str, str]]) -> List[List[str]]:
    """Elementary cycles of the order graph (DFS; deduped by node set)."""
    graph: Dict[str, Set[str]] = {}
    for a, b in edges:
        graph.setdefault(a, set()).add(b)
    cycles: List[List[str]] = []
    seen_sets: Set[frozenset] = set()

    def dfs(node: str, path: List[str], on_path: Set[str]) -> None:
        for nxt in sorted(graph.get(node, ())):
            if nxt in on_path:
                cycle = path[path.index(nxt):] + [nxt]
                key = frozenset(cycle)
                if key not in seen_sets:
                    seen_sets.add(key)
                    cycles.append(cycle)
                continue
            dfs(nxt, path + [nxt], on_path | {nxt})

    for start in sorted(graph):
        dfs(start, [start], {start})
    return cycles


# ---------------------------------------------------------------------------
# CONC.SHARED — multi-root shared mutable state
# ---------------------------------------------------------------------------


def _extended_thread_roots(mod: _ModuleInfo,
                           tree_targets: Set[str],
                           tree_handlers: Set[str]) -> Set[str]:
    """This module's thread-entry function names (incl. markers)."""
    roots = {n for n in tree_targets | tree_handlers if n in mod.funcs}
    for name, node in mod.funcs.items():
        if _marker_at(mod.markers, node, "root") is not None:
            roots.add(name)
    return roots


def _accesses(node: ast.AST, names: Set[str]) -> Set[str]:
    """Module-level names from ``names`` read or written under ``node``."""
    out: Set[str] = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and sub.id in names:
            out.add(sub.id)
    return out


def check_shared_state(mod: _ModuleInfo, tree_targets: Set[str],
                       tree_handlers: Set[str]) -> List[Finding]:
    shared = mod.mutables - mod.immutable_marked - mod.queue_typed
    if not shared:
        return []
    roots = _extended_thread_roots(mod, tree_targets, tree_handlers)
    if not roots:
        return []
    reach_per_root = {r: _reachable({r}, mod.graph) for r in roots}
    thread_reachable = set().union(*reach_per_root.values())

    # which roots can touch each global? "<main>" covers module-level code
    # and every function no thread root reaches (it runs on the caller's
    # thread — almost always the main one)
    roots_touching: Dict[str, Set[str]] = {g: set() for g in shared}
    for r, reach in reach_per_root.items():
        for fname in reach:
            for g in _accesses(mod.funcs[fname], shared):
                roots_touching[g].add(r)
    for fname, node in mod.funcs.items():
        if fname not in thread_reachable:
            for g in _accesses(node, shared):
                roots_touching[g].add("<main>")
    for stmt in mod.tree.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        for g in _accesses(stmt, shared):
            roots_touching[g].add("<main>")

    findings: List[Finding] = []
    ordinals: Dict[Tuple[str, str], int] = {}

    def mutated_name(node: ast.AST) -> Optional[str]:
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                base = t
                while isinstance(base, (ast.Subscript, ast.Attribute)):
                    base = base.value
                if isinstance(base, ast.Name) and base.id in shared \
                        and base is not t:
                    return base.id
        if isinstance(node, ast.Expr) and isinstance(node.value, ast.Call):
            call = node.value
            if isinstance(call.func, ast.Attribute) \
                    and call.func.attr in _MUTATOR_METHODS \
                    and isinstance(call.func.value, ast.Name) \
                    and call.func.value.id in shared:
                return call.func.value.id
        return None

    def visit(node: ast.AST, fname: str, locked: bool) -> None:
        if isinstance(node, ast.With):
            locked = locked or _is_lock_guard(node)
        name = mutated_name(node)
        if name is not None and not locked \
                and len(roots_touching[name]) >= 2 \
                and not _line_optout(mod.lines, node, "CONC.SHARED"):
            key = (fname, name)
            ordinals[key] = ordinals.get(key, 0) + 1
            findings.append(Finding(
                id=make_id("CONC.SHARED", mod.rel, fname, name,
                           ordinals[key]),
                check="CONC.SHARED", family="concurrency",
                message=f"module-level {name!r} is reachable from "
                        f"{len(roots_touching[name])} thread roots "
                        f"({', '.join(sorted(roots_touching[name]))}) and "
                        f"mutated in {fname} without a lock — guard it, "
                        f"pass it through a queue, or mark it "
                        f"`# mct-thread: immutable`",
                file=mod.rel, line=getattr(node, "lineno", 0)))
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            visit(child, fname, locked)

    for fname in sorted(thread_reachable):
        if fname not in mod.funcs:
            continue
        for child in ast.iter_child_nodes(mod.funcs[fname]):
            visit(child, fname, False)
    return findings


# ---------------------------------------------------------------------------
# CONC.SIGNAL — handlers touch only Event/flag state
# ---------------------------------------------------------------------------


def collect_signal_handlers(tree: ast.Module) -> Set[str]:
    """Function names registered via ``signal.signal(SIG, fn)``."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            chain = _attr_chain(node.func) or ""
            if chain == "signal.signal" and len(node.args) == 2 \
                    and isinstance(node.args[1], ast.Name):
                out.add(node.args[1].id)
    return out


_SIGNAL_ALLOWED_TAILS = {"set", "is_set", "clear"}
_SIGNAL_ALLOWED_CHAINS = {"os._exit", "os.kill", "signal.signal"}
# read-only builtins that neither block, lock, nor allocate containers —
# everything else (logging, IO, json, print, dict/list construction) is
# re-entrancy surface a handler must not touch
_SIGNAL_SAFE_BUILTINS = {"isinstance", "getattr", "hasattr", "len", "id",
                         "type", "repr"}
_SIGNAL_TOKEN_CAP = 8  # aggregate message stays one readable line


def check_signal_handlers(mod: _ModuleInfo, handlers: Set[str]
                          ) -> List[Finding]:
    local = {h for h in handlers if h in mod.funcs}
    if not local:
        return []
    graph = mod.graph
    findings: List[Finding] = []
    for handler in sorted(local):
        node = mod.funcs[handler]
        if _line_optout(mod.lines, node, "CONC.SIGNAL"):
            continue
        offending: Dict[str, str] = {}  # chain -> via
        for fname in sorted(_reachable({handler}, graph)):
            via = "" if fname == handler else f" (via {fname})"
            for sub in ast.walk(mod.funcs[fname]):
                if not isinstance(sub, ast.Call):
                    continue
                chain = _attr_chain(sub.func) or ""
                tail = chain.rsplit(".", 1)[-1]
                if chain in _SIGNAL_ALLOWED_CHAINS \
                        or tail in _SIGNAL_ALLOWED_TAILS \
                        or chain in _SIGNAL_SAFE_BUILTINS:
                    continue
                if isinstance(sub.func, ast.Name) \
                        and sub.func.id in mod.funcs:
                    continue  # module-local: its body is walked itself
                offending.setdefault(chain or "<call>", via)
        if offending:
            items = sorted(offending.items())
            toks = ", ".join(f"{c}{v}" for c, v in
                             items[:_SIGNAL_TOKEN_CAP])
            if len(items) > _SIGNAL_TOKEN_CAP:
                toks += f", +{len(items) - _SIGNAL_TOKEN_CAP} more"
            findings.append(Finding(
                id=make_id("CONC.SIGNAL", mod.rel, handler),
                check="CONC.SIGNAL", family="concurrency",
                message=f"signal handler {handler} reaches beyond "
                        f"Event/flag state: {toks} — a handler interrupts "
                        f"its own thread mid-anything; set a flag and "
                        f"return",
                file=mod.rel, line=node.lineno))
    return findings


# ---------------------------------------------------------------------------
# CONC.JOIN — bounded join or an explicit abandon rationale
# ---------------------------------------------------------------------------


def _walk_own_scope(scope: ast.AST) -> Iterable[ast.AST]:
    """ast.walk that does NOT descend into nested function/class defs —
    a spawn inside a def belongs to that def's scope, not its parent's."""
    work = list(ast.iter_child_nodes(scope))
    while work:
        node = work.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
            work.extend(ast.iter_child_nodes(node))


def check_thread_joins(mod: _ModuleInfo) -> List[Finding]:
    findings: List[Finding] = []
    ordinals: Dict[str, int] = {}

    def spawn_sites(scope: ast.AST) -> List[Tuple[ast.Call, Optional[str]]]:
        """(Thread ctor call, assigned name | None) in this scope only."""
        assigned_calls: Dict[int, str] = {}
        out: List[Tuple[ast.Call, Optional[str]]] = []
        for sub in _walk_own_scope(scope):
            if isinstance(sub, ast.Assign) \
                    and isinstance(sub.value, ast.Call) \
                    and len(sub.targets) == 1 \
                    and isinstance(sub.targets[0], ast.Name):
                chain = _attr_chain(sub.value.func) or ""
                if chain.rsplit(".", 1)[-1] == "Thread":
                    assigned_calls[id(sub.value)] = sub.targets[0].id
        for sub in _walk_own_scope(scope):
            if isinstance(sub, ast.Call):
                chain = _attr_chain(sub.func) or ""
                if chain.rsplit(".", 1)[-1] == "Thread":
                    out.append((sub, assigned_calls.get(id(sub))))
        return out

    def joins_of(scope: ast.AST) -> Dict[str, bool]:
        """name -> bounded? for every ``NAME.join(...)`` in this scope."""
        out: Dict[str, bool] = {}
        for sub in _walk_own_scope(scope):
            if isinstance(sub, ast.Call) \
                    and isinstance(sub.func, ast.Attribute) \
                    and sub.func.attr == "join" \
                    and isinstance(sub.func.value, ast.Name):
                bounded = bool(sub.args or sub.keywords)
                name = sub.func.value.id
                out[name] = out.get(name, False) or bounded
        return out

    scopes: List[Tuple[str, ast.AST]] = [("<module>", mod.tree)]
    scopes += [(name, node) for name, node in mod.funcs.items()]
    for scope_name, scope in scopes:
        joins = joins_of(scope)
        for call, assigned in spawn_sites(scope):
            rationale = _marker_at(mod.markers, call, "abandon")
            if rationale is not None:
                if not rationale.strip():
                    findings.append(Finding(
                        id=make_id("CONC.JOIN", mod.rel, scope_name,
                                   "empty-rationale"),
                        check="CONC.JOIN", family="concurrency",
                        message=f"{scope_name}: `# mct-thread: abandon()` "
                                f"needs a rationale — an empty abandonment "
                                f"is folklore, not a contract",
                        file=mod.rel, line=call.lineno))
                continue
            if assigned is not None and assigned in joins:
                if joins[assigned]:
                    continue  # bounded join
                tag = f"{assigned}-unbounded-join"
                msg = (f"{scope_name}: thread {assigned!r} is joined "
                       f"without a timeout — an unbounded join is the "
                       f"wedge the watchdogs exist to prevent; pass "
                       f"a timeout or mark the spawn "
                       f"`# mct-thread: abandon(<why>)`")
            else:
                tag = assigned or "anonymous"
                msg = (f"{scope_name}: thread {tag!r} is spawned and never "
                       f"joined — join it with a timeout or mark the spawn "
                       f"line `# mct-thread: abandon(<why>)` (the "
                       f"daemon-abandonment pattern, as a contract)")
            if _line_optout(mod.lines, call, "CONC.JOIN"):
                continue
            ordinals[tag] = ordinals.get(tag, 0) + 1
            findings.append(Finding(
                id=make_id("CONC.JOIN", mod.rel, scope_name, tag,
                           ordinals[tag]),
                check="CONC.JOIN", family="concurrency",
                message=msg, file=mod.rel, line=call.lineno))
    return findings


# ---------------------------------------------------------------------------
# CONC.RESULT — .result() without a timeout (blocking-call taxonomy)
# ---------------------------------------------------------------------------


def check_result_timeouts(mod: _ModuleInfo) -> List[Finding]:
    findings: List[Finding] = []
    ordinals: Dict[str, int] = {}
    scope_of: Dict[int, str] = {}
    for name, fn in mod.funcs.items():
        for sub in ast.walk(fn):
            scope_of[id(sub)] = name
    for sub in ast.walk(mod.tree):
        if not (isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)
                and sub.func.attr == "result"
                and not sub.args and not sub.keywords):
            continue
        if _line_optout(mod.lines, sub, "CONC.RESULT"):
            continue
        fname = scope_of.get(id(sub), "<module>")
        ordinals[fname] = ordinals.get(fname, 0) + 1
        findings.append(Finding(
            id=make_id("CONC.RESULT", mod.rel, fname, ordinals[fname]),
            check="CONC.RESULT", family="concurrency",
            message=f".result() without a timeout in {fname} blocks "
                    f"unboundedly on another thread — pass a timeout (the "
                    f"watchdog budgets exist for exactly this) or opt out "
                    f"with `# mct-ok: CONC.RESULT`",
            file=mod.rel, line=sub.lineno))
    return findings


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------


def _parse_tree(repo_root: str, roots: Sequence[str]
                ) -> Tuple[List[_ModuleInfo], List[Finding]]:
    mods: List[_ModuleInfo] = []
    findings: List[Finding] = []
    import os

    for path in _iter_py_files(repo_root, roots):
        rel = os.path.relpath(path, repo_root).replace(os.sep, "/")
        try:
            with open(path, "r", encoding="utf-8") as f:
                source = f.read()
            tree = ast.parse(source, filename=path)
        except (OSError, SyntaxError) as e:
            findings.append(Finding(
                id=make_id("CONC.PARSE", rel), check="CONC.PARSE",
                family="concurrency", message=f"could not parse: {e}",
                file=rel))
            continue
        mods.append(_ModuleInfo(rel, tree, source.splitlines()))
    return mods, findings


def _lock_walk_tree(mods: Sequence[_ModuleInfo]
                    ) -> Tuple[Set[str], _LockWalkResult]:
    """One lock walk over the parsed tree: (canonical lock ids, result).

    The single implementation behind both drivers — ``analyze_concurrency``
    keeps the blocking-call findings, ``build_lock_order_graph`` keeps the
    node/edge sets.
    """
    tree_module_locks: Dict[str, str] = {}
    for mod in mods:
        tree_module_locks.update(mod.module_locks)
    nodes: Set[str] = set(tree_module_locks.values())
    result = _LockWalkResult()
    for mod in mods:
        nodes.update(mod.class_locks.values())
        acq = _acquire_fixpoint(mod, _direct_acquires(mod,
                                                      tree_module_locks))
        _walk_locks(mod, acq, _blocking_fixpoint(mod), tree_module_locks,
                    result)
    nodes.update({_METRICS_LOCK, _EVENTS_LOCK})
    return nodes, result


def build_lock_order_graph(repo_root: str,
                           roots: Sequence[str] = SCAN_ROOTS
                           ) -> Tuple[Set[str], Set[Tuple[str, str]]]:
    """(canonical lock ids, order edges) — the static graph the runtime
    sanitizer's observed graph must embed into (lock_sanitizer.check_embeds)."""
    mods, _ = _parse_tree(repo_root, roots)
    nodes, result = _lock_walk_tree(mods)
    return nodes, set(result.edges)


def analyze_concurrency(repo_root: str,
                        roots: Sequence[str] = SCAN_ROOTS
                        ) -> List[Finding]:
    """Run the concurrency family over the tree; pure stdlib, no torch."""
    mods, findings = _parse_tree(repo_root, roots)

    # tree-wide topology: thread targets and signal handlers
    tree_targets: Set[str] = set(THREAD_ENTRY_HINTS)
    tree_handlers: Set[str] = set()
    for mod in mods:
        tree_targets |= collect_thread_targets(mod.tree)
        tree_handlers |= collect_signal_handlers(mod.tree)

    _, lock_walk = _lock_walk_tree(mods)
    for mod in mods:
        findings += check_shared_state(mod, tree_targets, tree_handlers)
        findings += check_signal_handlers(mod, tree_handlers)
        findings += check_thread_joins(mod)
        findings += check_result_timeouts(mod)
    findings += lock_walk.findings

    for cycle in _find_cycles(lock_walk.edges):
        anchor_rel, anchor_line = lock_walk.edges.get(
            (cycle[0], cycle[1]), ("", 0))
        findings.append(Finding(
            id=make_id("CONC.LOCKORDER", "+".join(sorted(set(cycle)))),
            check="CONC.LOCKORDER", family="concurrency",
            message=f"lock-order cycle {' -> '.join(cycle)} — two threads "
                    f"taking these locks in opposite orders deadlock; "
                    f"impose one global order",
            file=anchor_rel, line=anchor_line))
    return findings
