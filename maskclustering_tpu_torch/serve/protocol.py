"""mct-serve wire protocol: line-delimited JSON over a local socket (the port's
copy of ``maskclustering_tpu/serve/protocol.py``).

One request or response per ``\\n``-terminated line; every line is a JSON
object carrying ``v`` (protocol version). The daemon answers a scene
request with an immediate ``ack`` (the daemon-assigned request id), then
streams ``status`` events (queued -> running, retry/degrade decisions)
and exactly one terminal ``result`` — or a typed ``reject`` instead of
the ack when admission refuses the work. Stdlib-only: clients need
nothing from the rest of the tree.

Request ops::

    {"op": "scene", "scene": "scene0001_00",
     "deadline_s": 30.0,          # optional per-request budget (0 = none)
     "resume": false,             # optional: artifact/journal resume
     "tag": "client-key",         # optional: echoed on every event
     "tenant": "team-a"}          # optional: accounting identity — the
                                  # telemetry plane attributes requests,
                                  # latency, queue waits, crashes,
                                  # device-seconds and d2h bytes per
                                  # tenant (obs/telemetry.py windows)
    {"op": "scene", "scene": "synth-a",
     "synthetic": {"num_boxes": 3, "num_frames": 10,
                   "image_hw": [60, 80], "spacing": 0.06, "seed": 40}}
    {"op": "stream_chunk", "scene": "synth-a", "chunk": 8,
     "synthetic": {...}}          # accumulate the scene's NEXT frame
                                  # chunk (live-scan streaming); result
                                  # carries partial_instances + done.
                                  # The scene name IS the stream identity
                                  # (one producer per scene, like the
                                  # artifact paths) — two clients
                                  # streaming one scene interleave on a
                                  # single cursor
    {"op": "stream_end", "scene": "synth-a"}  # finalize + export the
                                  # stream's artifacts, drop its session
                                  # (only on success — a failed export
                                  # keeps it, resend the op)
    {"op": "status"}              # daemon stats snapshot
    {"op": "status", "detail": "telemetry"}  # + windowed telemetry ring
    {"op": "shutdown"}            # drain in-flight requests, then exit
    {"op": "recarve", "carve": "2x4", "workers": 2}  # worker-pool admin
                                  # op (serve/pool.py): drain every
                                  # slice, respawn under the new carve
                                  # (admission keeps queueing meanwhile;
                                  # the shared AOT cache keeps the new
                                  # slices warm). Answers an ack-shaped
                                  # {"kind": "recarve", "ok": ...}

Responses (all carry ``id`` when bound to a request)::

    {"kind": "ack", "id": "r-000001", "scene": ..., "queue_depth": 2}
    {"kind": "reject", "reason": "queue_full" | "deadline" |
                                 "bad_request" | "draining", ...}
    {"kind": "status", "id": ..., "state": "running" | "retrying" |
                                           "degraded" | "worker_crash", ...}
    {"kind": "result", "id": ..., "status": "ok" | "failed" | "skipped" |
                                            "deadline", ...}

``worker_crash`` (process-isolated serving only, serve/supervisor.py):
the device-owning worker subprocess died under this request; the request
was requeued (``requeued: true``) for the respawned worker (in a pool,
rerouted to a bucket-warm neighbor), or — after repeated crashes — the
next event is a ``failed`` result with ``error_class: "device"``.

``stream_lost`` (status + terminal, streaming under crash containment):
the worker holding this scene's device-resident ``_StreamSession`` died
— the accumulator state died with it, so the stream CANNOT silently
continue (the wire ``chunk`` field is frames-per-chunk, not a cursor; a
respawned worker would reopen the stream at chunk 0 and corrupt it).
In-flight and queued stream ops for the lost scene answer a ``status``
with ``state: "stream_lost"`` then a ``failed`` result with
``error_class: "stream_lost"``; the session is dropped so the client can
restart the stream from its own source. When the daemon runs with a
shared ``stream_state/`` directory (serve/wal.py durability plane), a
per-chunk accumulator snapshot usually exists and the stream instead
RESUMES on the respawned worker (or a surviving pool slice): the client
sees a ``worker_crash`` status with ``requeued: true`` and the chunk
answers ``ok`` as if nothing died — ``stream_lost`` remains the typed
terminal fallback when no snapshot exists or the resumed replay exhausts
``MAX_REQUEST_CRASHES``.

``idem`` (optional, scene-naming ops): a client-chosen idempotency key.
The daemon journals it in the admission WAL; a reconnect-and-resubmit
with the same key dedupes instead of re-running — an already-answered
key replays the cached terminal event (stamped ``deduped: true``), an
in-flight key re-attaches the new connection to the live request's
status stream.

The same shapes ride the supervisor<->worker pipe (see
``forward_request``), plus three pipe-only kinds: ``hb`` (heartbeat),
``ready`` (worker warm, carries the retrace/aot digest) and ``bye``
(drain complete).

``quota`` rejects and the ``recarve`` op are worker-pool surface
(serve/pool.py): quota = the tenant's configured queued-request bound
(config.serve_tenants) was hit; recarve = drain + respawn the pool
under a new ``serve_carve`` while admission keeps queueing.
"""

from __future__ import annotations

import dataclasses
import json
import math
import time
from typing import Dict, Optional

PROTOCOL_VERSION = 1

# accounting identities are dict keys in telemetry windows and column
# labels in obs.top — bound their length so a hostile client cannot bloat
# every window row
TENANT_MAX_LEN = 64

# idempotency keys are dict keys in the daemon's dedupe map and ride WAL
# rows verbatim — same bounded-identity rule as tenants
IDEM_MAX_LEN = 128

OPS = ("scene", "stream_chunk", "stream_end", "status", "shutdown",
       "recarve")
# the ops that name a scene and ride the admission queue as work items
SCENE_OPS = ("scene", "stream_chunk", "stream_end")
# status op detail levels: "" (the classic point-in-time snapshot),
# "telemetry" (adds the windowed aggregator's ring + cumulative digest)
# or "slo" (telemetry plus the armed spec's burn-rate verdict, obs/slo.py)
# or "sentinel" (the canary sentinel's drift-plane snapshot, obs/canary.py)
STATUS_DETAILS = ("", "telemetry", "slo", "sentinel")
REJECT_REASONS = ("queue_full", "deadline", "bad_request", "draining",
                  "quota")
RESULT_STATUSES = ("ok", "failed", "skipped", "deadline", "interrupted")

# make_scene parameters an inline synthetic request may set; anything else
# is a bad_request (the daemon must not forward arbitrary kwargs into the
# generator)
SYNTHETIC_PARAMS = frozenset({
    "num_boxes", "num_frames", "image_hw", "spacing", "seed", "room_half",
    "camera_radius", "camera_height", "floor_spacing",
})


class ProtocolError(ValueError):
    """A request line the daemon cannot admit (reason: bad_request)."""


@dataclasses.dataclass
class SceneRequest:
    """One admitted unit of work (daemon-internal; not the wire shape)."""

    id: str
    scene: str
    op: str = "scene"  # "scene" | "stream_chunk" | "stream_end"
    chunk: int = 0  # stream_chunk only: frames per chunk (0 = config)
    synthetic: Optional[Dict] = None
    deadline_s: float = 0.0
    resume: bool = False
    tag: str = ""
    tenant: str = ""  # optional accounting identity ("" = untenanted)
    idem: str = ""  # optional idempotency key ("" = no dedupe contract)
    admitted_at: float = 0.0       # time.monotonic() at admission
    deadline_at: float = math.inf  # monotonic deadline (inf = none)
    # how many device workers this request has crashed (the isolated
    # worker supervisor stamps it on requeue; the respawned worker's
    # SceneSupervisor starts that many degradation rungs down)
    crashes: int = 0
    send = None  # bound by the daemon: callable(event dict) -> None

    def expired(self) -> bool:
        return time.monotonic() >= self.deadline_at

    def remaining_s(self) -> float:
        return max(self.deadline_at - time.monotonic(), 0.0)


def parse_line(line: str) -> Dict:
    """One wire line -> validated request dict (raises ProtocolError)."""
    line = line.strip()
    if not line:
        raise ProtocolError("empty request line")
    try:
        doc = json.loads(line)
    except ValueError as e:
        raise ProtocolError(f"not JSON: {e}") from e
    if not isinstance(doc, dict):
        raise ProtocolError("request must be a JSON object")
    op = doc.get("op")
    if op not in OPS:
        raise ProtocolError(f"unknown op {op!r} (one of {OPS})")
    if op == "status":
        detail = doc.get("detail", "")
        if detail not in STATUS_DETAILS:
            raise ProtocolError(f"unknown status detail {detail!r} "
                                f"(one of {STATUS_DETAILS})")
    if op == "recarve":
        workers = doc.get("workers", 0)
        if not isinstance(workers, int) or isinstance(workers, bool) \
                or workers < 0:
            raise ProtocolError("'workers' must be an integer >= 0")
        carve = doc.get("carve", "")
        if not isinstance(carve, str):
            raise ProtocolError("'carve' must be a 'KxC' string")
    if op in SCENE_OPS:
        scene = doc.get("scene")
        if not isinstance(scene, str) or not scene:
            raise ProtocolError(f"{op} op needs a non-empty 'scene' name")
        if os_sep_like(scene):
            raise ProtocolError(f"scene name {scene!r} must not contain "
                                "path separators")
        chunk = doc.get("chunk", 0)
        if not isinstance(chunk, int) or isinstance(chunk, bool) or chunk < 0:
            raise ProtocolError("'chunk' must be an integer >= 0")
        if chunk and op != "stream_chunk":
            raise ProtocolError("'chunk' only applies to the stream_chunk "
                                "op")
        syn = doc.get("synthetic")
        if syn is not None:
            if not isinstance(syn, dict):
                raise ProtocolError("'synthetic' must be an object of "
                                    "make_scene params")
            unknown = set(syn) - SYNTHETIC_PARAMS
            if unknown:
                raise ProtocolError(
                    f"unknown synthetic param(s) {sorted(unknown)} "
                    f"(allowed: {sorted(SYNTHETIC_PARAMS)})")
        deadline = doc.get("deadline_s", 0.0)
        if not isinstance(deadline, (int, float)) or deadline < 0:
            raise ProtocolError("'deadline_s' must be a number >= 0")
        if not isinstance(doc.get("resume", False), bool):
            raise ProtocolError("'resume' must be a boolean")
        if "tenant" in doc:
            tenant = doc["tenant"]
            if not isinstance(tenant, str) or not tenant:
                raise ProtocolError("'tenant' must be a non-empty string")
            if len(tenant) > TENANT_MAX_LEN:
                raise ProtocolError(f"'tenant' longer than {TENANT_MAX_LEN} "
                                    "chars")
            if os_sep_like(tenant):
                raise ProtocolError(f"tenant {tenant!r} must not contain "
                                    "path separators")
        if "idem" in doc:
            idem = doc["idem"]
            if not isinstance(idem, str) or not idem:
                raise ProtocolError("'idem' must be a non-empty string")
            if len(idem) > IDEM_MAX_LEN:
                raise ProtocolError(f"'idem' longer than {IDEM_MAX_LEN} "
                                    "chars")
            if os_sep_like(idem):
                raise ProtocolError(f"idem key {idem!r} must not contain "
                                    "path separators")
        if "crashes" in doc:
            # supervisor-internal (the pipe carries it via forward_request,
            # which bypasses parse_line): a client must not pre-degrade its
            # own request's ladder — or crash the handler with a non-int
            raise ProtocolError("'crashes' is supervisor-internal and not "
                                "accepted on the client wire")
    return doc


def os_sep_like(name: str) -> bool:
    return "/" in name or "\\" in name or name in (".", "..")


def build_request(doc: Dict, request_id: str) -> SceneRequest:
    """A validated scene-naming op -> the daemon's work item."""
    deadline = float(doc.get("deadline_s", 0.0) or 0.0)
    now = time.monotonic()
    return SceneRequest(
        id=request_id,
        scene=doc["scene"],
        op=str(doc.get("op", "scene")),
        chunk=int(doc.get("chunk", 0) or 0),
        synthetic=doc.get("synthetic"),
        deadline_s=deadline,
        resume=bool(doc.get("resume", False)),
        tag=str(doc.get("tag", "")),
        tenant=str(doc.get("tenant", "")),
        idem=str(doc.get("idem", "")),
        admitted_at=now,
        deadline_at=(now + deadline) if deadline > 0 else math.inf,
        crashes=int(doc.get("crashes", 0) or 0),
    )


def forward_request(req: SceneRequest) -> Dict:
    """A ``SceneRequest`` -> the wire doc the supervisor pipes to its
    worker subprocess (serve/supervisor.py -> serve/worker_main.py).

    Carries the daemon-assigned ``id`` (the child assigns none), the
    REMAINING deadline budget (monotonic clocks do not cross process
    boundaries), and the crash count (the child's SceneSupervisor starts
    pre-degraded by it).
    """
    doc: Dict = {"op": req.op or "scene", "id": req.id, "scene": req.scene}
    if req.chunk:
        doc["chunk"] = req.chunk
    if req.synthetic is not None:
        doc["synthetic"] = req.synthetic
    if not math.isinf(req.deadline_at):
        doc["deadline_s"] = max(round(req.remaining_s(), 3), 0.001)
    if req.resume:
        doc["resume"] = True
    if req.tag:
        doc["tag"] = req.tag
    if req.tenant:
        doc["tenant"] = req.tenant
    if req.crashes:
        doc["crashes"] = req.crashes
    return doc


def forward_batch(reqs) -> Dict:
    """A same-bucket request batch -> ONE pipe envelope (pipe-only op).

    The supervisor's packing pump forwards a whole batch in one write so
    the child's scheduler sees the members together (its own
    ``next_batch`` re-packs them into one fused dispatch instead of
    meeting them one stdin line at a time). The envelope is
    supervisor-internal — ``parse_line`` never accepts it from a client.
    """
    return {"op": "batch", "requests": [forward_request(r) for r in reqs]}


# ---------------------------------------------------------------------------
# response builders (the only shapes the daemon ever sends)
# ---------------------------------------------------------------------------


def _event(kind: str, req: Optional[SceneRequest] = None, **fields) -> Dict:
    ev = {"v": PROTOCOL_VERSION, "kind": kind}
    if req is not None:
        ev["id"] = req.id
        if req.tag:
            ev["tag"] = req.tag
    ev.update(fields)
    return ev


def ack(req: SceneRequest, *, queue_depth: int) -> Dict:
    return _event("ack", req, scene=req.scene, queue_depth=queue_depth)


def reject(reason: str, *, req: Optional[SceneRequest] = None,
           detail: str = "", tag: str = "") -> Dict:
    assert reason in REJECT_REASONS, reason
    ev = _event("reject", req, reason=reason)
    if detail:
        ev["detail"] = detail
    if tag and "tag" not in ev:
        ev["tag"] = tag
    return ev


def status(req: SceneRequest, state: str, **fields) -> Dict:
    return _event("status", req, state=state, **fields)


def result(req: SceneRequest, status_: str, **fields) -> Dict:
    assert status_ in RESULT_STATUSES, status_
    return _event("result", req, status=status_, **fields)


def encode(event: Dict) -> bytes:
    return (json.dumps(event, sort_keys=True) + "\n").encode("utf-8")
