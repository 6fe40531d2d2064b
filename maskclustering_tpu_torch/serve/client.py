"""Minimal mct-serve client: one connection, blocking request/response (the port's
copy of ``maskclustering_tpu/serve/client.py``).

Stdlib-only (socket + json via serve/protocol): load_gen, the CI smoke
gate and the tests all talk to the daemon through this one client, so the
wire shapes have exactly one reader implementation. A ``ServeClient`` is
single-threaded by design — concurrent load uses one client (one
connection) per in-flight request, which keeps event demultiplexing out
of the protocol entirely.
"""

from __future__ import annotations

import json
import socket
import time
from typing import Dict, List, Optional, Tuple, Union

from maskclustering_tpu_torch.serve import protocol


class ServeClientError(RuntimeError):
    """The daemon closed the connection or sent something unreadable."""


class ServeClient:
    def __init__(self, address: Union[str, Tuple[str, int]],
                 timeout_s: float = 120.0):
        if isinstance(address, str):
            self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        else:
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.settimeout(timeout_s)
        self._sock.connect(address)
        self._buf = b""

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self) -> "ServeClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- wire ---------------------------------------------------------------

    def send(self, doc: Dict) -> None:
        self._sock.sendall(protocol.encode(doc))

    def recv_event(self) -> Dict:
        """One response line (blocking up to the socket timeout)."""
        while b"\n" not in self._buf:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ServeClientError("daemon closed the connection")
            self._buf += chunk
        line, self._buf = self._buf.split(b"\n", 1)
        try:
            return json.loads(line.decode("utf-8", "replace"))
        except ValueError as e:
            raise ServeClientError(f"unreadable response line: {e}") from e

    # -- requests -----------------------------------------------------------

    def request_scene(self, scene: str, *, synthetic: Optional[Dict] = None,
                      deadline_s: float = 0.0, resume: bool = False,
                      tag: str = "", tenant: str = "",
                      idem: str = "") -> Dict:
        """Submit one scene request; returns the ack or reject event.

        ``idem`` (optional) arms the daemon's WAL dedupe contract: a
        resubmit with the same key after a reconnect re-attaches to the
        running request or replays the cached terminal (``deduped``).
        """
        doc: Dict = {"op": "scene", "scene": scene}
        if synthetic is not None:
            doc["synthetic"] = synthetic
        if deadline_s:
            doc["deadline_s"] = deadline_s
        if resume:
            doc["resume"] = True
        if tag:
            doc["tag"] = tag
        if tenant:
            doc["tenant"] = tenant
        if idem:
            doc["idem"] = idem
        self.send(doc)
        return self.recv_event()

    def wait_result(self, *, collect: Optional[List[Dict]] = None) -> Dict:
        """Read events until the terminal one (result or reject).

        ``collect`` (optional) receives every intermediate status event.
        """
        while True:
            ev = self.recv_event()
            if ev.get("kind") in ("result", "reject"):
                return ev
            if collect is not None:
                collect.append(ev)

    def run_scene(self, scene: str, **kw) -> Tuple[Dict, List[Dict], float]:
        """request + wait: (terminal event, status events, latency seconds)."""
        t0 = time.monotonic()
        first = self.request_scene(scene, **kw)
        if first.get("kind") == "reject":
            return first, [], time.monotonic() - t0
        assert first.get("kind") == "ack", first
        statuses: List[Dict] = []
        terminal = self.wait_result(collect=statuses)
        return terminal, statuses, time.monotonic() - t0

    # -- live-scan streaming ------------------------------------------------

    def stream_chunk(self, scene: str, *, chunk: int = 0,
                     synthetic: Optional[Dict] = None, deadline_s: float = 0.0,
                     tag: str = "", tenant: str = "",
                     idem: str = "") -> Tuple[Dict, List[Dict]]:
        """Accumulate the scene's next frame chunk on the daemon.

        Returns ``(terminal event, status events)`` — the terminal result
        carries ``partial_instances`` (the anytime instance count) and
        ``done`` (all frames consumed). ``chunk`` (frames per chunk) only
        matters on the FIRST op of a stream; 0 uses the daemon's config.
        """
        doc: Dict = {"op": "stream_chunk", "scene": scene}
        if chunk:
            doc["chunk"] = chunk
        if synthetic is not None:
            doc["synthetic"] = synthetic
        if deadline_s:
            doc["deadline_s"] = deadline_s
        if tag:
            doc["tag"] = tag
        if tenant:
            doc["tenant"] = tenant
        if idem:
            doc["idem"] = idem
        self.send(doc)
        first = self.recv_event()
        if first.get("kind") == "reject":
            return first, []
        assert first.get("kind") == "ack", first
        statuses: List[Dict] = []
        return self.wait_result(collect=statuses), statuses

    def stream_end(self, scene: str, *, tag: str = "") -> Tuple[Dict, List[Dict]]:
        """Finalize a stream: export artifacts, drop the session."""
        doc: Dict = {"op": "stream_end", "scene": scene}
        if tag:
            doc["tag"] = tag
        self.send(doc)
        first = self.recv_event()
        if first.get("kind") == "reject":
            return first, []
        assert first.get("kind") == "ack", first
        statuses: List[Dict] = []
        return self.wait_result(collect=statuses), statuses

    def stream_scene(self, scene: str, *, chunk: int = 0,
                     synthetic: Optional[Dict] = None,
                     max_chunks: int = 10000) -> Tuple[Dict, List[Dict]]:
        """Drive a whole scan: stream_chunk until ``done``, then
        stream_end. Returns the final result plus EVERY per-chunk
        terminal event (the partial-instance trajectory) — the one
        streaming flow load_gen, CI and the tests share."""
        chunk_events: List[Dict] = []
        for _ in range(max_chunks):
            ev, _st = self.stream_chunk(scene, chunk=chunk,
                                        synthetic=synthetic)
            chunk_events.append(ev)
            if ev.get("kind") != "result" or ev.get("status") != "ok":
                return ev, chunk_events
            if ev.get("done"):
                break
        else:
            # never finalize a stream the server has not reported done —
            # a silent partial export would be indistinguishable from a
            # complete scan to the caller
            raise ServeClientError(
                f"stream {scene!r} not done after {max_chunks} chunk "
                f"op(s); raise max_chunks or send stream_end yourself")
        final, _st = self.stream_end(scene)
        return final, chunk_events

    def stats(self, detail: str = "") -> Dict:
        doc: Dict = {"op": "status"}
        if detail:
            doc["detail"] = detail
        self.send(doc)
        while True:
            ev = self.recv_event()
            if ev.get("kind") == "stats":
                return ev

    def telemetry(self) -> Dict:
        """The stats snapshot plus the windowed telemetry ring (the
        ``obs.top`` dashboard's poll)."""
        return self.stats(detail="telemetry")

    def slo(self) -> Dict:
        """Telemetry plus the armed SLO spec's burn-rate verdict
        (obs/slo.py) under the ``slo`` key."""
        return self.stats(detail="slo")

    def sentinel(self) -> Dict:
        """The stats snapshot plus the canary sentinel's drift-plane
        matrix (obs/canary.py) under the ``sentinel`` key."""
        return self.stats(detail="sentinel")

    def recarve(self, workers: int = 0, carve: str = "") -> Dict:
        """Re-carve a pooled daemon's device mesh live (``recarve`` op).

        Returns the ``{"kind": "recarve", "ok": ...}`` answer; a
        single-worker daemon answers a ``bad_request`` reject instead."""
        doc: Dict = {"op": "recarve"}
        if workers:
            doc["workers"] = int(workers)
        if carve:
            doc["carve"] = carve
        self.send(doc)
        while True:
            ev = self.recv_event()
            if ev.get("kind") in ("recarve", "reject"):
                return ev

    def shutdown(self) -> Dict:
        self.send({"op": "shutdown"})
        return self.recv_event()
