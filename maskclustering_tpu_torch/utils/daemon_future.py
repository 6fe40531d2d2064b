"""One-shot future on a daemon thread (copy of ``utils/daemon_future.py:29``).

A daemon thread, unlike a ThreadPoolExecutor worker, which the interpreter
joins at exit, can never stall process shutdown on an abandoned blocking
call, e.g. a scene load mid-Ctrl-C (``run.py``'s prefetcher). The result or
the raised error is re-raised in ``result()`` so failures attribute to the
consuming stage.

``_value`` / ``_exc`` are written strictly before ``_done.set()`` and read
only after ``_done.wait()`` returns true: the Event's internal lock is the
happens-before edge. A consumer whose ``result(timeout)`` expired calls
``abandon()``; the worker then drops a late value instead of pinning it
(and a whole scene's tensors with it) on the future, and counts the drop as
``run.abandoned_results``.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional


def _drop_late() -> None:
    from maskclustering_tpu_torch.utils.faults import _count

    _count("run.abandoned_results")


class DaemonFuture:
    """Run ``fn`` on a daemon thread; ``result()`` blocks and re-raises."""

    def __init__(self, fn: Callable, name: str = "daemon-future"):
        self._done = threading.Event()
        self._abandoned = threading.Event()
        self._value = None
        self._exc: Optional[BaseException] = None

        def work():
            try:
                value = fn()
            except BaseException as e:  # noqa: BLE001 — re-raised in result()
                if self._abandoned.is_set():
                    _drop_late()  # an abandoned error is a drop too
                else:
                    self._exc = e
            else:
                if self._abandoned.is_set():
                    _drop_late()
                else:
                    self._value = value
            finally:
                self._done.set()

        threading.Thread(  # mct-thread: abandon(one-shot daemon worker: result(timeout) bounds the consumer's wait and abandon() drops a late value; a join would re-create the shutdown stall this class exists to avoid)
            target=work, daemon=True, name=name).start()

    def abandon(self) -> None:
        """Declare this future's consumer gone (its ``result`` timed out):
        a value the worker produces after this call is dropped."""
        self._abandoned.set()

    def result(self, timeout: Optional[float] = None):
        """Block for the value (re-raising the worker's error); raises
        ``TimeoutError`` when the worker has not finished in ``timeout``
        seconds."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"daemon future did not finish within {timeout}s")
        if self._exc is not None:
            raise self._exc
        return self._value
