"""Family 2: AST lint over ``maskclustering_tpu_torch/`` + ``chip_smoke.py``.

Counterpart of ``maskclustering_tpu/analysis/ast_checks.py``, with torch's
vocabulary. Four domain checks no generic linter expresses:

- **AST.HOSTSYNC** — unsanctioned host-sync calls (``.item()``,
  ``.cpu()``, ``.tolist()``, ``.numpy()``, ``np.asarray``,
  ``torch.cuda.synchronize``, and ``float(...)``/``bool(...)`` of a call
  result: each waits for the card's queue) in the device-path modules.
  Sanctioned means the call sits in a ``with`` block whose ITEMS declare a
  pull seam: a ``sanctioned_pull`` context, or a span whose name contains
  ``"pull"`` / that passes a ``host_pull`` attr (the port's stage spans
  name their pulls ``post.<stage>.pull`` with ``host_pull=<what>``). Body-level markers (a booked ``d2h``, a
  ``host_pull`` attr set later) deliberately do NOT sanction — they
  would blind the lint to a second pull added to the same block; booked
  but unwrapped pulls live in the baseline instead.
  Scope is ``DEVICE_PATH_MODULES`` only — host-side numpy plumbing is not
  a sync hazard, and diagnostics scripts sync on purpose.
- **AST.JITPURITY** — wall-clock/randomness reachable from compiled or
  traced code: module-local reachability from every traced root
  (functions passed to or decorated with ``torch.compile``,
  ``torch.jit.script``/``trace``, a ``torch.func`` transform, or any
  ``*.jit``) to a ``time.*``/``np.random``/``random``/``datetime.now``
  call. Tracing bakes the value at compile time — a silent wrong-answer
  bug. The port compiles and traces nothing today, so the check finds
  nothing on its tree; it guards the day it does.
- **AST.THREADS** — module-level mutable state mutated without a lock in
  thread-reachable code (an unlocked metrics registry racing its executor threads as the
  motivating pattern): entry points are functions handed to
  ``DaemonFuture``/``threading.Thread``/``faults.call_with_deadline``
  anywhere in the tree (plus
  ``THREAD_ENTRY_HINTS`` for cross-module dispatch), reachability closes
  over same-module calls, and a mutation counts as guarded only inside a
  ``with <...lock...>`` block.
- **AST.EXCEPT** — bare ``except:`` handlers, which would swallow the
  typed fault classes of ``utils/faults.py`` (``DeviceStallError``
  carries the retry/degradation routing; a bare except eats it).

Inline opt-out: append ``# mct-ok: <CHECK>`` to the offending line (e.g.
``# mct-ok: AST.HOSTSYNC``) — for one-off sites where a baseline entry
would outlive the code it describes.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from maskclustering_tpu_torch.analysis.findings import Finding, make_id

# modules where an unsanctioned host sync is a perf bug, not plumbing: the
# counterparts of the JAX package's DEVICE_PATH_MODULES
DEVICE_PATH_MODULES = (
    "maskclustering_tpu_torch/models/pipeline.py",
    "maskclustering_tpu_torch/models/backprojection.py",
    "maskclustering_tpu_torch/models/graph.py",
    "maskclustering_tpu_torch/models/clustering.py",
    "maskclustering_tpu_torch/models/postprocess_device.py",
    "maskclustering_tpu_torch/models/streaming.py",
    "maskclustering_tpu_torch/parallel/sharded.py",
    "maskclustering_tpu_torch/parallel/batch.py",
    # io/feed.py is deliberately absent: the codec's encode half works on
    # host numpy by contract (it IS the declared h2d seam)
)

# functions dispatched onto worker threads from another module (the scene
# executors run run_scene_host on the host-tail DaemonFuture via a local
# closure; name-level thread-target collection cannot see through that)
THREAD_ENTRY_HINTS = ("run_scene_host",)

# torch entry points whose function-valued arguments get compiled or traced,
# and the transforms of torch.func. "compile" counts only through torch
# (re.compile is not one), "script"/"trace" only through torch.jit; a
# bare ``*.jit`` (any tracing JIT) counts as well
_TRACE_WRAPPERS = {"jit", "vmap", "grad", "grad_and_value", "jacrev", "jacfwd",
                   "hessian", "jvp", "vjp", "functional_call"}
_TORCH_JIT_WRAPPERS = {"script", "trace", "trace_module"}


def _is_trace_wrapper(chain: str) -> bool:
    parts = chain.split(".")
    tail = parts[-1]
    if tail in _TRACE_WRAPPERS:
        return True
    if tail == "compile":
        return "torch" in parts
    return tail in _TORCH_JIT_WRAPPERS and "jit" in parts[:-1]

_MUTATOR_METHODS = {"append", "extend", "add", "update", "pop", "popitem",
                    "setdefault", "clear", "insert", "remove", "discard",
                    "appendleft", "extendleft"}

_WALLCLOCK_TIME_ATTRS = {"time", "perf_counter", "monotonic", "time_ns",
                         "perf_counter_ns", "monotonic_ns"}

_MUTABLE_CTORS = {"dict", "list", "set", "defaultdict", "deque",
                  "OrderedDict", "Counter"}


def _attr_chain(node: ast.AST) -> Optional[str]:
    """'np.random.default_rng' for nested Attribute/Name; None otherwise."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _line_optout(source_lines: Sequence[str], node: ast.AST,
                 check: str) -> bool:
    ln = getattr(node, "lineno", 0)
    if not (1 <= ln <= len(source_lines)):
        return False
    line = source_lines[ln - 1]
    return f"# mct-ok: {check}" in line or "# mct-ok: all" in line


class _Scope:
    """Qualname + per-(scope, token) ordinal bookkeeping for stable ids."""

    def __init__(self):
        self.stack: List[str] = []
        self.ordinals: Dict[Tuple[str, str], int] = {}

    @property
    def qualname(self) -> str:
        return ".".join(self.stack) or "<module>"

    def ordinal(self, token: str) -> int:
        key = (self.qualname, token)
        self.ordinals[key] = self.ordinals.get(key, 0) + 1
        return self.ordinals[key]


# ---------------------------------------------------------------------------
# AST.HOSTSYNC
# ---------------------------------------------------------------------------


def _with_is_sanctioned(node: ast.With) -> bool:
    """Is this ``with`` a declared pull seam? (see module docstring)

    Only the WITH ITEMS sanction — a ``sanctioned_pull`` context or a
    pull-declaring span. A body-level marker (a ``host_pull`` attr set, a
    booked ``d2h``) must NOT sanction its whole block: a 30-line span
    body with one booked pull would blind the lint to a second pull
    added anywhere in it — the exact regression this check exists to
    catch. Booked-but-unwrapped pulls are baseline entries instead.
    """
    for item in node.items:
        call = item.context_expr
        if not isinstance(call, ast.Call):
            continue
        chain = _attr_chain(call.func) or ""
        if chain.endswith("sanctioned_pull"):
            return True
        if chain.endswith(".span") or chain == "span":
            if any(kw.arg == "host_pull" for kw in call.keywords):
                return True
            if (call.args and isinstance(call.args[0], ast.Constant)
                    and isinstance(call.args[0].value, str)
                    and "pull" in call.args[0].value):
                return True
    return False


# method calls that wait for the card: a pull to the host, or the queue's end
_SYNC_METHODS = ("item", "cpu", "tolist", "numpy")
_SYNC_CHAINS = ("np.asarray", "numpy.asarray", "torch.cuda.synchronize")


def check_host_syncs(tree: ast.Module, rel: str,
                     source_lines: Sequence[str]) -> List[Finding]:
    findings: List[Finding] = []
    scope = _Scope()

    def sync_token(call: ast.Call) -> Optional[str]:
        chain = _attr_chain(call.func)
        if chain in _SYNC_CHAINS:
            return chain
        if isinstance(call.func, ast.Attribute) and call.func.attr in _SYNC_METHODS:
            return f".{call.func.attr}"
        if isinstance(call.func, ast.Name) and call.func.id in ("float", "bool") \
                and call.args and isinstance(call.args[0], ast.Call):
            return f"{call.func.id}(<call>)"
        return None

    def visit(node: ast.AST, sanctioned: bool) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            scope.stack.append(node.name)
            for child in ast.iter_child_nodes(node):
                visit(child, sanctioned)
            scope.stack.pop()
            return
        if isinstance(node, ast.With):
            sanctioned = sanctioned or _with_is_sanctioned(node)
        if isinstance(node, ast.Call):
            token = sync_token(node)
            if token and not sanctioned \
                    and not _line_optout(source_lines, node, "AST.HOSTSYNC"):
                findings.append(Finding(
                    id=make_id("AST.HOSTSYNC", rel, scope.qualname, token,
                               scope.ordinal(token)),
                    check="AST.HOSTSYNC", family="ast",
                    message=f"{token} outside a sanctioned host_pull seam "
                            f"(in {scope.qualname}) — an undeclared device "
                            f"sync on the device path",
                    file=rel, line=node.lineno))
        for child in ast.iter_child_nodes(node):
            visit(child, sanctioned)

    visit(tree, False)
    return findings


# ---------------------------------------------------------------------------
# AST.JITPURITY
# ---------------------------------------------------------------------------


def _collect_functions(tree: ast.Module) -> Dict[str, ast.AST]:
    """name -> def node for every (possibly nested) function in the module.

    Bare names: the module-local call graph resolves simple ``f(...)``
    calls; shadowing across scopes is rare enough that last-def-wins is an
    acceptable approximation for a linter.
    """
    out: Dict[str, ast.AST] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = node
    return out


def _function_args_of_call(call: ast.Call) -> Iterable[str]:
    for arg in list(call.args) + [kw.value for kw in call.keywords]:
        if isinstance(arg, ast.Name):
            yield arg.id


def _traced_roots(tree: ast.Module, funcs: Dict[str, ast.AST]) -> Set[str]:
    """Functions handed to compiling/tracing machinery (or decorated with it)."""
    roots: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            chain = _attr_chain(node.func) or ""
            if _is_trace_wrapper(chain):
                roots.update(n for n in _function_args_of_call(node)
                             if n in funcs)
            # functools.partial(torch.compile, ...)(impl)
            if isinstance(node.func, ast.Call):
                inner = node.func
                inner_chain = _attr_chain(inner.func) or ""
                if inner_chain.rsplit(".", 1)[-1] == "partial" and any(
                        _is_trace_wrapper(_attr_chain(a) or "")
                        for a in inner.args):
                    roots.update(n for n in _function_args_of_call(node)
                                 if n in funcs)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                chain = _attr_chain(dec) or ""
                if isinstance(dec, ast.Call):
                    chain = _attr_chain(dec.func) or ""
                    if chain.rsplit(".", 1)[-1] == "partial" and any(
                            _is_trace_wrapper(_attr_chain(a) or "")
                            for a in dec.args):
                        roots.add(node.name)
                        continue
                if _is_trace_wrapper(chain):
                    roots.add(node.name)
    return roots


def _call_graph(funcs: Dict[str, ast.AST]) -> Dict[str, Set[str]]:
    graph: Dict[str, Set[str]] = {}
    for name, node in funcs.items():
        callees: Set[str] = set()
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name) \
                    and sub.func.id in funcs and sub.func.id != name:
                callees.add(sub.func.id)
        graph[name] = callees
    return graph


def _reachable(roots: Set[str], graph: Dict[str, Set[str]]) -> Set[str]:
    seen, work = set(roots), list(roots)
    while work:
        for callee in graph.get(work.pop(), ()):
            if callee not in seen:
                seen.add(callee)
                work.append(callee)
    return seen


def _impure_token(call: ast.Call) -> Optional[str]:
    chain = _attr_chain(call.func) or ""
    parts = chain.split(".")
    if len(parts) == 2 and parts[0] == "time" \
            and parts[1] in _WALLCLOCK_TIME_ATTRS:
        return chain
    if len(parts) >= 2 and parts[0] in ("np", "numpy") \
            and parts[1] == "random":
        return chain
    if len(parts) == 2 and parts[0] == "random":
        return chain
    if chain in ("datetime.now", "datetime.datetime.now", "os.urandom"):
        return chain
    return None


def check_jit_purity(tree: ast.Module, rel: str,
                     source_lines: Sequence[str]) -> List[Finding]:
    funcs = _collect_functions(tree)
    roots = _traced_roots(tree, funcs)
    if not roots:
        return []
    reachable = _reachable(roots, _call_graph(funcs))
    findings: List[Finding] = []
    ordinals: Dict[Tuple[str, str], int] = {}

    def walk_own_body(root: ast.AST) -> Iterable[ast.AST]:
        """ast.walk minus nested def bodies — a nested function is its own
        ``funcs`` entry, reached (or not) through the call graph; walking
        it here would double-report its calls and flag never-traced
        nested callbacks."""
        work = list(ast.iter_child_nodes(root))
        while work:
            node = work.pop()
            yield node
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                work.extend(ast.iter_child_nodes(node))

    for fname in sorted(reachable):
        for sub in walk_own_body(funcs[fname]):
            if isinstance(sub, ast.Call):
                token = _impure_token(sub)
                if token and not _line_optout(source_lines, sub,
                                              "AST.JITPURITY"):
                    key = (fname, token)
                    ordinals[key] = ordinals.get(key, 0) + 1
                    findings.append(Finding(
                        id=make_id("AST.JITPURITY", rel, fname, token,
                                   ordinals[key]),
                        check="AST.JITPURITY", family="ast",
                        message=f"{token} inside {fname}, which is "
                                f"reachable from compiled code — the value "
                                f"is baked at trace time, not read per "
                                f"call",
                        file=rel, line=sub.lineno))
    return findings


# ---------------------------------------------------------------------------
# AST.THREADS
# ---------------------------------------------------------------------------


def collect_thread_targets(tree: ast.Module) -> Set[str]:
    """Function names handed to DaemonFuture(...) / Thread(target=...) /
    call_with_deadline(...) (the watchdog runs its target on a thread)."""
    targets: Set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        chain = _attr_chain(node.func) or ""
        tail = chain.rsplit(".", 1)[-1]
        if tail in ("DaemonFuture", "call_with_deadline") and node.args \
                and isinstance(node.args[0], ast.Name):
            targets.add(node.args[0].id)
        if tail == "Thread":
            for kw in node.keywords:
                if kw.arg == "target" and isinstance(kw.value, ast.Name):
                    targets.add(kw.value.id)
        # executor-shaped receivers: `ex`/`executor` AND `pool` spellings
        # (semantics/features.py's io pool is literally `pool.map(...)`)
        receiver = chain.lower()
        if tail in ("submit", "map") \
                and ("ex" in receiver or "pool" in receiver) and node.args \
                and isinstance(node.args[0], ast.Name):
            targets.add(node.args[0].id)
    return targets


def _module_level_mutables(tree: ast.Module) -> Set[str]:
    names: Set[str] = set()
    for stmt in tree.body:
        targets = []
        if isinstance(stmt, ast.Assign):
            targets, value = stmt.targets, stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets, value = [stmt.target], stmt.value
        else:
            continue
        mutable = isinstance(value, (ast.Dict, ast.List, ast.Set,
                                     ast.DictComp, ast.ListComp,
                                     ast.SetComp))
        if isinstance(value, ast.Call):
            chain = _attr_chain(value.func) or ""
            mutable = chain.rsplit(".", 1)[-1] in _MUTABLE_CTORS
        if mutable:
            names.update(t.id for t in targets if isinstance(t, ast.Name))
    return names


def _is_lock_guard(node: ast.With) -> bool:
    for item in node.items:
        expr = item.context_expr
        chain = _attr_chain(expr) or ""
        if isinstance(expr, ast.Call):
            chain = _attr_chain(expr.func) or chain
        if "lock" in chain.lower():
            return True
    return False


def check_thread_shared_state(tree: ast.Module, rel: str,
                              source_lines: Sequence[str],
                              thread_targets: Set[str]) -> List[Finding]:
    """Unlocked mutation of module-level mutable state in thread-reachable
    functions. ``thread_targets`` is the TREE-WIDE set of thread entry
    names (collect_thread_targets over every file + THREAD_ENTRY_HINTS);
    reachability closes within this module."""
    mutables = _module_level_mutables(tree)
    if not mutables:
        return []
    funcs = _collect_functions(tree)
    entries = {n for n in thread_targets if n in funcs}
    if not entries:
        return []
    reachable = _reachable(entries, _call_graph(funcs))
    findings: List[Finding] = []
    ordinals: Dict[Tuple[str, str], int] = {}

    def mutated_name(node: ast.AST) -> Optional[str]:
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                base = t
                while isinstance(base, (ast.Subscript, ast.Attribute)):
                    base = base.value
                if isinstance(base, ast.Name) and base.id in mutables \
                        and base is not t:  # plain rebinding is not mutation
                    return base.id
        if isinstance(node, ast.Expr) and isinstance(node.value, ast.Call):
            call = node.value
            if isinstance(call.func, ast.Attribute) \
                    and call.func.attr in _MUTATOR_METHODS \
                    and isinstance(call.func.value, ast.Name) \
                    and call.func.value.id in mutables:
                return call.func.value.id
        return None

    def visit(node: ast.AST, fname: str, locked: bool) -> None:
        if isinstance(node, ast.With):
            locked = locked or _is_lock_guard(node)
        name = mutated_name(node)
        if name is not None and not locked \
                and not _line_optout(source_lines, node, "AST.THREADS"):
            key = (fname, name)
            ordinals[key] = ordinals.get(key, 0) + 1
            findings.append(Finding(
                id=make_id("AST.THREADS", rel, fname, name, ordinals[key]),
                check="AST.THREADS", family="ast",
                message=f"module-level {name!r} mutated in {fname} without "
                        f"a lock, and {fname} runs on an executor thread — "
                        f"the unlocked-registry race pattern",
                file=rel, line=node.lineno))
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue  # nested defs are their own reachability entries
            visit(child, fname, locked)

    for fname in sorted(reachable):
        for child in ast.iter_child_nodes(funcs[fname]):
            visit(child, fname, False)
    return findings


# ---------------------------------------------------------------------------
# AST.EXCEPT
# ---------------------------------------------------------------------------


def check_bare_except(tree: ast.Module, rel: str,
                      source_lines: Sequence[str]) -> List[Finding]:
    findings: List[Finding] = []
    n = 0
    for node in ast.walk(tree):
        if isinstance(node, ast.ExceptHandler) and node.type is None \
                and not _line_optout(source_lines, node, "AST.EXCEPT"):
            n += 1
            findings.append(Finding(
                id=make_id("AST.EXCEPT", rel, n),
                check="AST.EXCEPT", family="ast",
                message="bare 'except:' swallows the typed fault classes "
                        "(utils/faults.py DeviceStallError carries "
                        "retry/degradation routing) — catch Exception or "
                        "narrower",
                file=rel, line=node.lineno))
    return findings


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

# chip_smoke.py rides along for the thread/except lints (its client and
# sampler threads drive the daemons on the card)
SCAN_ROOTS = ("maskclustering_tpu_torch", "chip_smoke.py")


def _iter_py_files(repo_root: str,
                   roots: Sequence[str] = SCAN_ROOTS) -> Iterable[str]:
    for root in roots:
        base = os.path.join(repo_root, root)
        if os.path.isfile(base) and base.endswith(".py"):
            yield base
            continue
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    yield os.path.join(dirpath, fn)


def analyze_ast(repo_root: str,
                roots: Sequence[str] = SCAN_ROOTS) -> List[Finding]:
    """Run Family 2 over the tree; pure stdlib, no torch import."""
    parsed: List[Tuple[str, ast.Module, List[str]]] = []
    thread_targets: Set[str] = set(THREAD_ENTRY_HINTS)
    for path in _iter_py_files(repo_root, roots):
        rel = os.path.relpath(path, repo_root).replace(os.sep, "/")
        try:
            with open(path, "r", encoding="utf-8") as f:
                source = f.read()
            tree = ast.parse(source, filename=path)
        except (OSError, SyntaxError) as e:
            parsed.append((rel, None, [f"{e}"]))
            continue
        lines = source.splitlines()
        parsed.append((rel, tree, lines))
        thread_targets |= collect_thread_targets(tree)

    findings: List[Finding] = []
    for rel, tree, lines in parsed:
        if tree is None:
            findings.append(Finding(
                id=make_id("AST.PARSE", rel), check="AST.PARSE", family="ast",
                message=f"could not parse: {lines[0]}", file=rel))
            continue
        if rel in DEVICE_PATH_MODULES:
            findings += check_host_syncs(tree, rel, lines)
        findings += check_jit_purity(tree, rel, lines)
        findings += check_thread_shared_state(tree, rel, lines,
                                              thread_targets)
        findings += check_bare_except(tree, rel, lines)
    return findings
