"""mct-serve: the long-lived scene-serving daemon of the port (the
counterpart of ``maskclustering_tpu/serve``).

The batch driver (``run.py``) walks a scene list and exits. This package
keeps the process — and with it the card's warm allocator, loaded kernels
and the router's warm shape buckets — alive across requests:

- ``protocol``  — line-delimited JSON request/response schema (the JAX
  package's, byte for byte: a client of either daemon talks to both);
- ``admission`` — bounded queue, typed rejects, per-request deadlines;
- ``router``    — shape-bucket classification (``utils/compile_cache.
  scene_bucket``) and serving-vocabulary warm-up from
  ``compile_surface_baseline.json``;
- ``wal``       — the crash-safe admission write-ahead log (a WAL written
  by one package is recovered by the other);
- ``worker``    — the single card-owning thread driving
  ``run.SceneSupervisor`` per request (per-request retry/degradation,
  journal, obs spans, ``serve.*`` metrics), packed batches and streams;
- ``supervisor`` / ``worker_main`` — the crash-contained topology: the
  card-owning worker as a supervised subprocess over a stdio JSONL pipe
  (heartbeats, SIGKILL on silence, bounded respawn, requeue, the telemetry
  relay), the daemon's own process device-free;
- ``pool``      — K supervised slices behind one affinity-aware,
  weighted-fair tenant scheduler with quotas and live recarve;
- ``daemon``    — socket front + lifecycle (SIGTERM drains in flight);
- ``client``    — the one blocking client implementation.

Start one with ``python -m maskclustering_tpu_torch.serve --config scannet
--socket /tmp/mct.sock`` (``--device cpu`` for the CPU; ``--isolate-worker``
for the subprocess worker, ``--workers K --isolate-worker`` for a pool).
"""

from maskclustering_tpu_torch.serve.admission import AdmissionQueue, QueueFullReject
from maskclustering_tpu_torch.serve.client import ServeClient
from maskclustering_tpu_torch.serve.daemon import ServeDaemon
from maskclustering_tpu_torch.serve.protocol import ProtocolError, SceneRequest, parse_line
from maskclustering_tpu_torch.serve.router import Router
from maskclustering_tpu_torch.serve.worker import ServeWorker

__all__ = [
    "AdmissionQueue", "QueueFullReject", "ServeClient", "ServeDaemon",
    "ProtocolError", "SceneRequest", "parse_line", "Router", "ServeWorker",
]
