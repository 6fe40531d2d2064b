"""Family 3: the runtime host-sync guard (opt-in, zero-cost when off).

Counterpart of ``maskclustering_tpu/analysis/transfer_guard.py``. The AST
lint sees syntactic syncs; it cannot see one born inside a library call: a
Python scalar uploaded into a device computation, a stray ``__array__`` on a
device tensor, a boolean-mask index that waits for the card to size its
output. This module guards the DEVICE PHASE of every scene
(``run_scene_device``) so any such read or wait raises
:class:`HostSyncError` at the offending line, on the CPU too, before a
card ever sees it.

Opt-in via ``run.py --transfer-guard`` or ``MCT_TRANSFER_GUARD=1``; an
explicit :func:`arm` takes precedence over the environment. Every host read
the port keeps opens a named ``sanctioned_pull`` window, and the guard
counts the windows of each guarded phase by name (:func:`scene_pulls`):
the JAX package has one such pull a scene (the mask table), the port a few
more, each named (``analysis/ir_checks.EXPECTED_HOST_SYNCS``).

``jax.transfer_guard`` is thread-local, and the overlapped executor relies
on that (the host-tail thread pulls claims while the dispatch thread is
guarded). ``torch.cuda.set_sync_debug_mode`` is one process-wide setting
that sees nothing on the CPU, so the guard is two layers:

- thread-local Python modes that run on both devices. A
  ``TorchFunctionMode`` catches host reads of a tensor (``item``,
  ``tolist``, ``numpy``, ``cpu``, ``to(<host>)`` of a card's tensor, ``__bool__``,
  ``__int__``, ``__float__``, ``__index__``, ``__array__``) and uploads of
  host values (``torch.tensor`` / ``as_tensor`` / ``asarray`` with a
  ``device``). A ``TorchDispatchMode`` catches the aten ops that make the
  host wait on CUDA: ``_local_scalar_dense``, ``nonzero``,
  ``masked_select``, ``unique*``, boolean-mask ``index`` / ``index_put``,
  ``repeat_interleave`` without ``output_size``, ``bincount`` (CUDA's reads
  the input's max to size its output, ``minlength`` or not) and a copy
  between the host and a card;
- on the card, :func:`arm_cuda_sync_check` adds
  ``torch.cuda.set_sync_debug_mode("error")`` over the guarded phase, lifted
  inside each window. Being process-wide, it is for sequential scans
  (``--no-overlap``) only: it shows that the thread-local layer misses no
  sync CUDA itself reports.

Off (the default) both context managers are a shared null context: no mode
is pushed and no tensor op pays anything.
"""

from __future__ import annotations

import contextlib
import functools
import os
import threading
from collections import Counter
from typing import Dict, Optional

ENV_FLAG = "MCT_TRANSFER_GUARD"

_armed: Optional[bool] = None  # None -> the environment decides
_cuda_check = False
_NULL = contextlib.nullcontext()
_tls = threading.local()
_LAST: Dict[str, int] = {}
_LAST_LOCK = threading.Lock()


class HostSyncError(RuntimeError):
    """A host read or wait inside a guarded device phase, outside every
    sanctioned window."""


def arm(on: Optional[bool]) -> None:
    """Explicitly enable/disable the guard (``None`` defers to the env)."""
    global _armed
    _armed = on


def enabled() -> bool:
    if _armed is not None:
        return _armed
    return os.environ.get(ENV_FLAG, "").strip().lower() in ("1", "true", "on", "yes")


def arm_cuda_sync_check(on: bool) -> None:
    """Add CUDA's own sync check (``set_sync_debug_mode("error")``) over
    every guarded phase on a card. Process-wide: sequential scans only."""
    global _cuda_check
    _cuda_check = bool(on)


def _active() -> bool:
    return getattr(_tls, "depth", 0) > 0 and getattr(_tls, "open", 0) == 0


def _violation(what: str) -> None:
    raise HostSyncError(
        f"host sync in a guarded device phase: {what} outside every sanctioned_pull "
        f"window (open one named for the pull, or keep the value on the device)")


# Tensor methods and torch functions that read a tensor on the host
_HOST_READS = frozenset({"item", "tolist", "numpy", "cpu", "__bool__", "__int__",
                         "__float__", "__index__", "__array__", "__complex__"})
_UPLOADS = frozenset({"tensor", "as_tensor", "asarray"})


def _to_host(args, kwargs) -> bool:
    """Whether ``Tensor.to(*args, **kwargs)`` moves a card's tensor to the
    host (on a host tensor it is a no-op, not a read)."""
    import torch

    if not isinstance(args[0], torch.Tensor) or args[0].device.type == "cpu":
        return False
    try:
        dev = torch._C._nn._parse_to(*args[1:], **kwargs)[0]
    except Exception:  # noqa: BLE001 — an unparsable call is torch's error to raise
        return False
    return dev is not None and dev.type == "cpu"


def _sync_op(func, args, kwargs) -> Optional[str]:
    """The name of an aten op that makes the host wait on CUDA, else None."""
    import torch

    name = func._overloadpacket.__name__
    if name in ("_local_scalar_dense", "nonzero", "masked_select", "bincount",
                "_unique", "_unique2", "unique_dim", "unique_consecutive",
                "unique_dim_consecutive"):
        return name
    if name == "repeat_interleave" and kwargs.get("output_size") is None and (
            len(args) < 3 or args[2] is None):
        if isinstance(args[0], torch.Tensor) and (len(args) == 1 or isinstance(
                args[1], torch.Tensor)):
            return "repeat_interleave without output_size"
    if name in ("index", "index_put", "index_put_"):
        idx = args[1] if len(args) > 1 else kwargs.get("indices", ())
        if any(isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in idx or ()):
            return f"boolean-mask {name}"
    if name == "_to_copy":
        src = args[0]
        dst = kwargs.get("device")
        if dst is not None and isinstance(src, torch.Tensor) and (
                torch.device(dst).type != src.device.type):
            return f"copy {src.device.type} -> {torch.device(dst).type}"
    if name == "copy_":
        dst, src = args[0], args[1]
        if (isinstance(src, torch.Tensor) and isinstance(dst, torch.Tensor)
                and src.device.type != dst.device.type):
            return f"copy {src.device.type} -> {dst.device.type}"
    return None


@functools.cache
def _mode_classes():
    """The (function mode, dispatch mode) classes, defined on first use so
    the module imports without torch."""
    from torch.overrides import TorchFunctionMode
    from torch.utils._python_dispatch import TorchDispatchMode

    class _HostReadMode(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if _active():
                name = getattr(func, "__name__", "")
                if name in _HOST_READS:
                    _violation(f"Tensor.{name}")
                if name == "to" and _to_host(args, kwargs):
                    _violation("Tensor.to(<host>)")
                if name in _UPLOADS and kwargs.get("device") is not None:
                    _violation(f"torch.{name}(<host value>, device=...) (a blocking upload: "
                               f"use torch.full((), v, device=...) for a scalar)")
            return func(*args, **kwargs)

    class _DeviceWaitMode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if _active():
                what = _sync_op(func, args, kwargs)
                if what is not None:
                    _violation(f"aten {what}")
            return func(*args, **kwargs)

    return _HostReadMode, _DeviceWaitMode


@contextlib.contextmanager
def _guarded():
    import torch

    depth = getattr(_tls, "depth", 0)
    if depth == 0:
        _tls.census = Counter()
        _tls.open = 0
    _tls.depth = depth + 1
    fmode, dmode = (cls() for cls in _mode_classes())
    cuda = _cuda_check and depth == 0 and torch.cuda.is_available()
    prev = torch.cuda.get_sync_debug_mode() if cuda else None
    try:
        if cuda:
            torch.cuda.set_sync_debug_mode("error")
        with fmode, dmode:
            yield
    finally:
        if cuda:
            torch.cuda.set_sync_debug_mode(prev)
        _tls.depth = depth
        if depth == 0:
            with _LAST_LOCK:
                _LAST.clear()
                _LAST.update(_tls.census)


def device_phase_guard():
    """The host-sync guard around a device phase when armed (a shared null
    context otherwise). Nested guards share the outer one's census."""
    return _guarded() if enabled() else _NULL


@contextlib.contextmanager
def _window(what: str):
    import torch

    _tls.census[what] += 1
    _tls.open = getattr(_tls, "open", 0) + 1
    cuda = _cuda_check and torch.cuda.is_available()
    prev = torch.cuda.get_sync_debug_mode() if cuda else None
    try:
        if cuda:
            torch.cuda.set_sync_debug_mode("default")
        yield
    finally:
        if cuda:
            torch.cuda.set_sync_debug_mode(prev)
        _tls.open -= 1


def sanctioned_pull(what: str):
    """A declared host-read window inside a guarded device phase.

    ``what`` names the pull; the guard counts the windows of each phase by
    name. The AST lint recognises this context manager as a sanctioned
    seam, so the runtime sanction and the static one stay one vocabulary.
    Outside a guarded phase (or disarmed) it is a shared null context.
    """
    if getattr(_tls, "depth", 0) == 0 or not enabled():
        return _NULL
    return _window(what)


@contextlib.contextmanager
def _paused():
    _tls.open = getattr(_tls, "open", 0) + 1
    try:
        yield
    finally:
        _tls.open -= 1


def host_values():
    """A computation on host tensors the process made itself, which reads
    no device value (a one-time capability probe): the guard's checks
    pause and nothing is counted. Not for reads of device results."""
    if getattr(_tls, "depth", 0) == 0:
        return _NULL
    return _paused()


def scene_pulls() -> Dict[str, int]:
    """The sanctioned windows of the last guarded phase that ended, by name."""
    with _LAST_LOCK:
        return dict(_LAST)
