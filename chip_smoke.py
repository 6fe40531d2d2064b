#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root, one CUDA card

Imports nothing of JAX or of the JAX package. In order:

1. card: its name and power limit (nvidia-smi) and torch's device name;
2. build: every CUDA kernel of the port, from the sources in this checkout;
3. kernels against their plain torch versions on the card, bit-equal, on
   the edge cases of ``ops/neighbor_cases.py`` (ragged lengths with empty
   rows, scan order rather than nearest, rows that fill in the middle of a
   warp step or exactly, k = 1, partial warps and blocks, S not a multiple
   of 4, partial last steps, no candidates, many tiles through the ring of
   buffers, blocks that stop with copies in flight);
4. the slice at full size through ``models.run_scene``: a 480x640 synthetic
   scan of 371,180 points, 32 frames, 2 mm depth noise, scannet thresholds,
   the reference radius 0.01, exact ball-query association, host
   post-process, on ``cuda``; every kernel of the path must have launched.
   The padded inputs of every ball-query group it launched are kept;
5. the ball-query kernel bit-equal to its plain version on every one of
   those groups; timed with CUDA events at the largest group beside its
   plain version, its bound and the no-FMA ceiling, and summed over the
   scene's groups;
6. a mid-size scene on ``cuda`` and on ``cpu``: equal artifact digests;
7. the association's three scene entries (``ops/cuda/associate.cu``: the
   pixel table, the claim and the assignment, one launch each over a stack
   of frames) bit-equal to their plain scene versions on
   the edge cases of ``ops/association_cases.py``: every one-frame case as
   a scene of one frame (points behind the camera, footprints off every
   border, pixel centres on .5, claim distances at and a few ulps around
   r2, windows 0-3, k_max 63 and 1023, an invalid frame, N not a multiple
   of the block) and the multi-frame cases (an invalid frame and a padded
   all-zero pose, a frame with every point behind the camera, every lane
   claiming one id, a different id on every lane at k_max 1023, N not a
   multiple of the block); the frame or scene on ``cuda`` equal to
   ``cpu``; ``torch.addcmul`` on the card rounds once, as on the CPU;
8. the default configuration (dense association, device post-process) at
   full size through ``models.run_scene``: the scene of phase 4,
   ``distance_threshold`` 0.01, ``k_max`` 63, ``post_neighbor_cap`` raised
   to the smallest power of two that holds the scene's largest DBSCAN
   degree (printed). The scene entries' inputs and outputs are kept; each
   must have launched once for the scene, and all three are bit-equal to
   their plain versions on all frames and timed per scene with CUDA
   events, beside the plain versions and the bound. The association stage alone
   is timed and its host synchronisations counted
   (``torch.cuda.set_sync_debug_mode``). One more run under
   ``torch.profiler`` gives the card's busy share of the scene and the
   kernels that take most of it (trace in ``build/dense_trace.json``);
9. the default configuration on the mid-size scene of phase 6 on ``cuda``
   and on ``cpu``: equal artifact digests and assignments;
10. the batch driver (``run.run_pipeline``) on scans on disk: the scene of
    phase 4 written in the ScanNet layout by the port's writer once and
    copied to two more names, the mid-size scene written as a fourth
    (``build/chip_smoke_scans``; bytes and seconds per scan); each
    full-size scan loaded back and equal,
    array for array, to what was written, its depth quantised to
    millimetres; the uint16 feed engaged and its decode on the card equal
    to the host float32 bit for bit, its host encode and upload timed
    beside the plain float32/int32 upload; one 16-bit frame of Paeth rows
    decoded and timed; the first scan's id-maps (PIL's row filters) decoded
    and timed, beside their rows through the wavefront alone and the same
    pixels as filter-0 rows. The three full-size scans through ``cluster`` and
    ``eval_ca`` (``post_neighbor_cap`` 1024), overlapped and sequential,
    into two prediction roots: equal npz arrays, object dicts and AP, every
    digest equal to ``run_scene`` on the loaded scan, each association
    entry launched once a scene; scene and loop walls and the overlap
    ratio printed. The mid-size scan on ``cuda`` and ``cpu``: equal
    artifacts and AP. The ladder drill: one full-size scan at the default
    ``post_neighbor_cap`` of 256 must end ``ok`` on the host-postprocess
    rung at its third attempt, equal to the cap-1024 run;
11. the plane digest lane and the semantic steps. Phase 8's full-size scene
    on ``cuda`` carries the digest dict (``plane`` lane included) of a
    ``cpu`` run (on the host post-process rung, whose digest the tests hold
    equal to the device rung's; it, the other CPU references of phases 11
    and 13 and the host renders of 13c and 14 run in three spawned
    processes started at the end of phase 8, two threads each at ``nice``
    10, no card visible), and phase 9's mid-size scene the same on both
    devices; the digest program and its pull are timed on the card.
    Phase 10's first
    full-size scan gets textured 968x1296 colour frames (ScanNet's colour
    size; the port's JPEG encoder, quality 90, 4:2:0), then ``features,
    label_features, query, eval`` with ``--encoder hash:1024`` run on it on
    ``cuda`` and on ``cpu``: equal features (bit for bit), class-aware npz
    and AP. Printed: one frame's decode time, the step seconds and the
    distinct frames decoded. (The ``cuda`` run took all three scans until
    phase 13 joined; one keeps the script's time.)
12. the CLIP encoder at ViT-H-14's full width (open_clip's ViT-H-14, the
    reference's ``laion2b_s32b_b79k`` shapes: image tower 1280 wide, 32
    layers, 16 heads, patch 14 at 224; text tower 1024 wide, 24 layers,
    vocabulary 49,408; projection 1024), its weights drawn from a seeded
    ``torch.Generator`` and written in the open_clip layout under
    ``build/chip_smoke_clip`` with a byte-level tokenizer and a 224-pixel
    preprocessor (bytes, write and load seconds). Eight crops of phase 11's
    textured frames and sixteen labels encoded on ``cuda`` and on ``cpu``:
    at most 1e-4 apart (max abs difference and least cosine printed). The
    image tower's ms a crop at batch 64 and the text tower's ms a label
    (CUDA events), each beside its FP32 bound, and the peak device memory.
    Then ``features, label_features, query, eval`` with ``--encoder
    hf:build/chip_smoke_clip`` on ``cuda`` over the first full-size scan:
    the encoder's weights all on the card, 1024-wide finite features, a
    198 x 1024 label file of unit vectors, classes in the vocabulary.
13. streaming (``models.stream_scene``) and the fault drills. (a) Phase 8's
    scene and config in one chunk of 32: the digest dict and artifacts of
    phase 8. (b) Four chunks of 8 on ``cuda`` and on ``cpu`` (a CPU-reference
    process): every chunk's
    digest, partial-instance count, mask count and plane bytes equal, and
    the objects, assignment and digest; each association kernel launched
    once a chunk; per chunk its seconds, plane bytes and launches, the
    three streaming programs timed again on each chunk's inputs, and the
    finalize with its host DBSCAN. (c) Peak device memory and wall, batch
    against chunks of 16, on a 48-frame render of the full-size scene
    (rendered in a CPU-reference process).
    (d) Drills: on a mid-size scene streamed in three
    chunks, ``flaky:<scene>.chunk:1`` heals and
    ``stall:<scene>.chunk:1`` under a 5 s watchdog is retried while the
    abandoned attempt raises ``StaleChunkAttempt`` on its own thread, both
    with the fault-free artifacts; then ``python -m
    maskclustering_tpu_torch.run --fault-plan`` over phase 10's four scans
    with the JAX drill's four faults (load, a device stall, flaky twice, a
    post-process overflow): statuses, attempts and rungs of the port's
    two-rung ladder, every healed scan's artifacts equal to phase 10's (the
    CLI starts at the end of phase 10 and runs beside phases 11-13: it
    reads the scans and writes under its own config name).
    (e) ``streaming_chunk`` 8 through the batch driver over phase 10's
    three scans: cluster seconds and AP beside the batch run's.
14. the fused multi-device path (``parallel/``). (a) ``cluster_scene_batch``
    on a (1, 1) mesh of the card over two 480x640 lanes, phase 8's scene
    and a render of 16 frames from another seed (a CPU-reference process),
    phase 8's config: each
    lane's artifact digest equals ``run_scene``'s (the first is phase 8's),
    each association kernel launched once a lane; the batch's seconds a
    scene beside phase 8's ``run_scene`` wall, and the peak device memory
    for one lane and for two. (b) The same batch on meshes that repeat the
    card, (2, 1), (1, 2), (1, 1, 2) and (2, 2, 2): the same digests, one
    launch of each kernel a lane x frame shard x point shard, and each
    point shard of a lane's ``first_id`` holding N_pad / P columns on its
    device. (c) Phase 9's mid-size scene as a batch of one on ``cuda`` and
    on ``cpu``: phase 9's digest on both. (d) The batch driver over phase
    10's scans: the CLI with ``mesh_shape`` [1, 1] and ``--point-shards 1``,
    ``run_pipeline`` on a (2, 1) mesh with two point shards over the card
    four times (``mesh_devices``; the short last batch has a pad lane), and
    the CLI with ``--workers 2`` over the four scans, the two CLIs'
    processes started at the head of the phase beside (a)-(d)'s in-process
    runs: npz, object dicts and AP equal to phase 10's (the mid-size scan
    to an in-process run), the seconds a scan beside phase 10's.
15. the scene-serving daemon (``serve/``) in this process, one in-thread
    worker on the card, over phase 10's scans and config on a Unix socket.
    (a) Start with one scan warm, obs events armed: the warm-up seconds.
    (b) ``ServeClient.run_scene`` on each scan and a repeat of the first:
    ``ack``, ``status running``, ``result ok``, phase 10's artifact digest
    and object count, one launch of each association kernel a request; a
    synthetic scene at a bucket this process never dispatched, cold then
    warm (``buckets_new``); the seconds of each beside phase 8's wall (obs
    off). (c) Three requests from three client threads at capacity 2: every
    admitted one ok with the same digests, any ``queue_full`` typed; p50,
    p95, requests a second and the queue high-water. (e) ``stream_chunk``
    x4 (chunks of 8) and ``stream_end`` over one scan: artifacts and digest
    equal to an in-process ``stream_scene``. (g) ``status`` with
    ``detail="slo"``: counts, latency quantiles, telemetry windows and the
    SLO result. (f) One request held in flight (a device stall) and two
    queued, then stop: ok for the first, ``draining`` rejects for the
    others; a second daemon on the same journal directory recovers the WAL
    and dedupes the answered key; the events file holds ``serve.request``
    spans and ``serve.*`` counters. (d) A daemon with ``serve_batch_max``
    2: two same-bucket scans in one fused dispatch, ``batch`` 2, (b)'s
    digests, each association kernel once a lane.

16. obs on the card, files under a temporary directory. Phase 8's scene
    again with obs off and armed (the walls beside phase 8's). (a) ``python -m
    maskclustering_tpu_torch.run --report R.json --ledger <tmp>`` over one
    of phase 10's scans: ``R_events.jsonl``, the report's ``obs`` digest
    with one ``associate``/``graph``/``cluster``/``postprocess`` span each,
    ``pipeline.host_sync`` equal to the scene's pulls, phase 10's digest and
    one ledger row; the armed seconds beside phase 10's. (b) ``python -m
    maskclustering_tpu_torch.obs.report`` on the events file, ``--diff``
    against a second armed run, ``--history`` over both rows, ``--regress``
    passing against the first row (its headline at least the newest
    row's) and failing against half the newest row's headline, the five
    runs at once (they only read files). (c) A
    daemon in the canary goldens' configuration with ``--warm-baseline``
    and the sentinel armed every second against ``canary_goldens.json``:
    two rounds or more, no drift, the SLO's ``correctness`` met; one more
    round with the ticks stopped: every probe's digest the committed
    golden's, its seconds and launches (one of each association kernel a
    probe). (e) While it runs, one served request traced with ``python -m
    maskclustering_tpu_torch.obs.trace`` (queue wait, then the execution
    with the stage spans nested, then the journal's outcome) and ``python
    -m maskclustering_tpu_torch.obs.top --once``, both at once. (d) The
    drift drill: goldens
    with one artifact digest changed give the ``canary.drift`` event, a
    flight dump naming the coordinate, the counter, a window's ``drift``
    and a violated ``correctness``. (f) The mid-size scene streamed in
    chunks of 8 with obs armed: ``stream.chunks`` and the ``stream.chunk``
    spans equal to the chunks, one ``stream.finalize``, the digest of the
    same stream unarmed. ``PERF_LEDGER.jsonl`` and ``canary_goldens.json``
    keep their bytes. Phase 17(a)'s daemon starts once the two timed runs
    of phase 8's scene are done, beside (a)-(f).
17. the crash-contained topology, every daemon a ``python -m
    maskclustering_tpu_torch.serve --isolate-worker`` subprocess over phase
    10's scans and config, files under a temporary directory. (a) One
    isolated worker warm on a scan (its daemon started in phase 16): spawn
    to ready, the child's warm-up
    and no build in it; the first two scans served with phase 10's digests
    (since PR 18; the third is the same scene again),
    their seconds beside phase 15's in-thread ones, polled for the
    heartbeat age, and the first again unpolled; the child holds a context and the
    daemon none (``nvidia-smi``, or the open ``/dev/nvidiaN`` files where
    its pids are not this namespace's); the child's ``bye`` (after (b)'s
    readings: its warm child holds the same memory through them) counts one
    launch of each association kernel a scan. (b) ``crash:<scan>.device:1``
    with a 10 s heartbeat, its daemon spawned and warmed beside (a)'s
    requests: ``worker_crash`` then ``ok`` at rung 1 with phase
    10's digest, the respawn's seconds, the crash, requeue and respawn
    counters 1 each, the dead child's context gone and the card's memory
    back within 64 MiB after the drain. (c) ``wedge:<scan>.device:1`` with
    a 5 s heartbeat, in a child with no warm scan: detected, SIGKILLed,
    respawned, ``ok``; (d)'s daemon starts and warms beside it, and (e)'s
    daemon, the ``--carve 2x1`` daemon and the order burst's pool beside
    (d). (d) A pool of two on the one card, tenants
    ``a:3,b:1:2``: three clients, a request each, over two buckets, both
    slices dispatching, affinity hits; a burst in which the
    third queued ``b`` request gets a typed ``quota`` reject; a crash on
    slice 0 rerouted to slice 1; ``recarve`` to one worker with a request
    in flight; ``--carve 2x1`` refused at start; in this process, a pool
    of two real children dispatching a held burst in the 3:1 order of the
    stride scheduler (a thread beside (d)). (e) A stream in chunks of 8 on
    a pool with ``--stream-state`` (a thread beside (d)): its owner
    SIGKILLed with the second chunk in flight, the stream resumed on the
    survivor from the snapshot, its digest that of the in-process
    ``stream_scene``. The quota and order bursts (ten and eight requests of
    one scene on two slices exporting into one root) see 0 export retries.
    The phase prints its count of checks and its parts' seconds.
18. the ingestion front, files under a temporary directory. (a) A
    version-4 ``.sens`` capture of phase 4's scene through
    ``preprocess.write_sens``: its 32 frames' zlib depth and phase 11's
    textured 968x1296 colour as JPEG at quality 95 (bytes, seconds). (b)
    ``export_sens_scene`` at frame skip 10: the depth PNGs decode to the
    captured depth bit for bit, each colour file's SHA-256 is that of
    ``encode_jpeg(decode_jpeg(payload), 95)``; a seeded probe image's JPEG
    hashes to PIL's constant; one frame's decode, encode, resize and depth
    seconds; the first frame exported again at ``image_size=(480, 640)``
    (the bilinear path). (c) The cloud written, the masks step with
    ``cropformer_path`` ``"grid"`` on the card; every id-map byte-equal
    through ``device="cpu"`` (a thread beside (d)); ms a frame on each,
    sweeps, the largest id.
    (d) ``run_pipeline`` (masks, cluster) over the exported scan on the card
    in the default configuration and the exact one: objects, digests,
    seconds, each kernel's launches (``ingest_launches``); each run's
    objects and digests equal to the CPU route's on the same scan, which
    ``--ingest-reference`` computes (minutes on the CPU) and
    INGEST_CPU_DIGESTS keeps;
19. visualisation and the TASMap variant. (a) ``splat_depth``,
    ``splat_color`` and ``splat_bbox`` (``ops/cuda/splat.cu``) bit-equal to
    their plain versions, over F cameras and at F = 1, on the cases and
    batches of ``ops/splat_cases.py``; ``project_zbuffer`` and
    ``bbox(es)_by_projection`` on the card equal to the CPU's. (b) The
    ``vis`` and ``top_images`` steps over phase 10's second full-size scan
    on the card, the box inputs of every object kept: one ``splat_bbox``
    launch and one pull an object, no depth or colour pass; the same steps
    on the CPU into a second root: every file byte-equal. (c) The three
    entries bit-equal to their plain versions on every kept object, batched
    and at F = 1 (zero colours and seeded ones), the box equal to the one
    taken from the plain z-buffer with ``isfinite`` and ``nonzero``; each
    timed with CUDA events over the wrapper and as kernel-only time from a
    ``torch.profiler`` trace, at the largest object beside the plain
    version and the byte bound, and summed over the scan, beside the
    step's old schedule of two F = 1 passes a frame run through these
    kernels. (e) ``project_zbuffer``, the render entry, into every (object,
    frame) pair on the card, counts set to 0 just before: one depth and one
    colour launch a frame, equal to the CPU. (d) ``TASMAP_STEPS`` over
    the mid-size scan, copied without its masks and masked by ``"grid"``,
    on the card and on the CPU: every file equal (``tasmap_launches``);
20. the static checks: ``python -m maskclustering_tpu_torch.analysis``
    exits 0 against the port's baseline on the card's machine (no jax), while
    ``python -m maskclustering_tpu_torch.run --lock-sanitizer`` clusters
    phase 10's third scan: its ``locks.*`` counters in the events, its
    observed lock-order graph embedded in the static one.
21. the tooling (ROADMAP A10). (c) First, with nothing beside it: the cost
    observatory's five stages (``obs/cost.py``) on phase 8's scene padded as
    the fused step takes it, each census row beside the stage's time on the
    card (CUDA events) and its share of the roofline; the association
    kernels' bytes in the census equal to phase 8's bound bytes. (d) Beside
    the rest, in child processes: ``python -m maskclustering_tpu_torch.run
    --aot-cache DIR`` over phase 10's first scan, cold (every kernel
    library built), again (all restored, no ``nvcc``, the same digest) and
    on a copy of the cache whose entries carry another stamp (all
    invalidated and rebuilt, the same digest); ``prune`` removes the stale
    files. (f) Beside it too: ``python -m maskclustering_tpu_torch.analysis
    --families ir,retrace`` exits 0. (a) ``run_pipeline(profile_dir=...)``
    over that scan: the trace holds each association kernel once as a CUDA
    kernel event inside the ``associate`` range; ``xprof_spans=("associate",)``
    over the three scans writes exactly one trace. (b) Phase 8's scene under
    the host-sync guard: phase 8's digest, the sanctioned pulls by name; a
    sequential scan under the guard and ``set_sync_debug_mode("error")``;
    an injected ``.item()`` in the guarded phase raises. (e) A daemon warm on
    phase 10's first scan with the build/launch-surface sanitizer armed and
    frozen serves the other two with 0 builds and 0 new launch keys; a
    request in a new bucket after the freeze is a violation.

22. the zero-download demo (``python -m maskclustering_tpu_torch.demo``)
    at the JAX demo's default size (32 frames, 6 objects, 240x320, the nine
    steps on the hash encoder), in this process on the card (``demo.main``)
    and as a ``--device cpu`` child started after phase 17 and joined
    here: every file of the two roots equal, byte for byte (the vis and
    top-image PNGs, both evaluation files, the npz, object dict and PLY)
    but ``report.json`` and ``run_journal.jsonl``, field for field with
    their time fields set aside (DEMO_TIME_FIELDS); the ``[demo]`` lines
    equal but for their seconds and root; the association kernels and
    ``splat_bbox`` launched on the card (``demo_launches``); each step's
    seconds on both devices.

23. the JPEG kinds the port decodes since PR 18 (arithmetic sequential and
    progressive with DAC and restarts, block-smoothed cuts of Huffman and
    arithmetic progressive files, CMYK and YCCK, every integral sampling
    ratio, lossless) and those it refuses with cv2 and PIL: a CPU child
    started after phase 17 (``--jpeg-kinds``) makes every fixture of
    ``tests/jpeg_writers.py`` (numpy, and two small files PIL wrote under
    ``tests/jpeg_kinds/``) and holds ``read_rgb``, ``read_rgb_pil`` and
    ``decode_rgb`` to the goldens recorded from cv2 and PIL
    (``tests/jpeg_kinds/goldens.json``: the bytes, each route's pixels or
    its refusal), timing each decode; joined here. Then the ``features``
    step (``hash:64``) on the card over a small scan whose colour frames are
    arithmetic transcodes of its Huffman frames equals, bit for bit, the
    step over the Huffman frames.

24. the port's load generator and CI gate (``tools/``). (a) Inside phase
    15, before its drain, against its warm in-thread daemon (no new
    daemon): ``load_gen.run_load`` over the JAX tool's two buckets (24
    requests, concurrency 4, tenants ``A:3,B:1``), then over phase 10's first
    full-size scan as the one bucket (``BUCKET_SPECS`` overridden; 8
    requests, concurrency 2): every request ok, one launch of each
    association kernel a request, the verdict lines (p50, p95, requests a
    second) printed; in phase 24 every served digest equal, bucket by
    bucket, to ``run_scene``'s on the card and on the CPU (the full-size
    scan's CPU run a child, ``--serve-reference``, started after phase 17).
    (b) ``load_gen --smoke`` and ``--smoke --crash-drill`` as children on the
    card beside phases 18-23: zero post-freeze builds and new launch keys,
    and a respawned child with its three kernels restored from the build
    cache and none built. (c) ``tools/ci.py --device cpu`` with tier-1 off,
    a CPU child from the end of phase 2 at the lowest priority with no card
    visible: exit 0 with every gate run.

25. the device scene generator and the exact path's tool. The bench's
    scene (``utils/synthetic.make_scene_device``: 36 boxes, 250 frames of
    480x640, spacing 0.025, seed 0, rendered on the card by one
    ``render_depth_seg`` launch, ``ops/cuda/render.cu``), its cloud resized
    to 196,608 points, through ``run_scene`` in the default configuration at
    ``k_max`` 63 with the frames on the card: one warm run and 3 timed runs
    (walls, ``timings``, peak memory), counts set to 0 before the render and
    read after the runs; the same frames pulled to the host and fed through
    the feed on the card give the same digest and assignment. (a) The
    kernel bit-equal to its plain version (the JAX program in torch) on all
    250 frames on the card, on inputs rebuilt from the generator's host
    draws, and on the first 8 against the CPU's plain version (a thread
    beside the runs), and on the cases of ``ops/render_cases.py`` against
    both, and on 64 random 480x640 frames of 36 boxes (random poses and focal
    lengths, extreme ones included); its division form (``render.cu``'s
    test entry) equal to torch's division on the card on 10^8 pairs; timed
    with CUDA events in turns against the IEEE-division loop (the exact-only entry),
    beside the plain version and its operation bound; its SASS a (pixel,
    box) and (warp, box) from ``cuobjdump`` of the built library, with its
    registers and local memory. (c) ``python -m maskclustering_tpu_torch.tools.parity_ab`` on one
    shallow scene on the card, a child started after phase 17 at ``nice``
    10: exit 0, PASS, and its exact path launched the ball query. The other
    measurement tools' exits are held by their CPU tests and by their
    full-size runs through the chip tool (``PERF.md`` section 5).

``python3 chip_smoke.py --ingest-reference`` runs only that CPU route and
needs no card; ``--jpeg-kinds OUT`` runs only phase 23's fixture check and
writes its decode times to OUT; ``--serve-reference OUT`` only phase 24(a)'s
CPU run.

Every perf-ledger row of the script goes to a temporary file
(``MCT_PERF_LEDGER``). Any mismatch or failure exits non-zero. The last
three lines are the card line, the per-kernel JSON (each association row
with its launches in every path, ``isolated_launches`` read from the
isolated child's ``bye``, ``ingest_launches`` phase 18's,
``tasmap_launches`` phase 19d's, ``demo_launches`` phase 22's,
``load_gen_launches`` phase 24(a)'s; the depth
and colour rows' ``launches`` phase 19e's, ``splat_bbox``'s the top_images
step's, each beside its ``step_launches``, and ``splat_bbox``'s
``demo_launches`` phase 22's; the ball query's ``parity_launches`` phase
25(c)'s; ``render_depth_seg``'s ``launches`` phase 25's)
and the result JSON. ``[done]`` gives each phase's seconds.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import threading
import time

# NVIDIA's H100 SXM data sheet (dense, no sparsity), at its 700 W limit
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# the share of the FP32 bound a kernel without fused multiply-adds can
# reach: the peak above counts an FMA as two operations
NO_FMA_CEILING = 0.5
# the association kernels, in the order the path launches them
ASSOCIATION_KERNELS = ("associate_table", "associate_claim", "associate_assign")
# phase 8's DBSCAN neighbour table: the smallest power of two holding the
# full-size scene's largest same-rep degree (the default, 256, does not)
FULL_NEIGHBOR_CAP = 1024
# phase 10's scans on disk: the full-size scene under three names, the
# mid-size one as a fourth
BATCH_SCANS = ("scene0000_00", "scene0001_00", "scene0002_00")
# phase 17(a)'s polled requests: two of the three names of one scene, the
# third cut to pay for phase 23
ISO_SCANS = BATCH_SCANS[:2]
MID_SCAN = "scene0003_00"
# phase 11: ScanNet's colour size and a photo-like quality, ViT-H-14's
# feature width for the hash encoder
COLOR_HW = (968, 1296)
COLOR_QUALITY = 90
SEMANTIC_ENCODER = "hash:1024"
SEMANTIC_STEPS = ("features", "label_features", "query", "eval")
# phase 12: open_clip's ViT-H-14 (the reference checkpoint laion2b_s32b_b79k)
# at full width, random weights from a seed
VIT_H14 = {"embed_dim": 1024,
           "vision_cfg": {"image_size": 224, "layers": 32, "width": 1280, "head_width": 80,
                          "patch_size": 14, "mlp_ratio": 4.0},
           "text_cfg": {"context_length": 77, "vocab_size": 49408, "width": 1024, "heads": 16,
                        "layers": 24}}
CLIP_SEED = 0
CLIP_MERGES = 400
CLIP_CROPS = 8
CLIP_LABELS = 16
CLIP_BATCH = 64
CLIP_TOLERANCE = 1e-4
# phase 13: the full-size scene's 32 frames in four chunks; a longer scan
# (one and a half times the frames: three times took phase 13 past 150 s,
# and the script's budget took it down from twice) batch against
# chunked; the mid-size drills'
# watchdog and stall (the stall outlasts the watchdog, so the abandoned
# attempt wakes while or after its retry runs); the CLI drill's watchdog,
# which also covers its process's first device phase (CUDA's start
# included) while the CPU gate child shares the host: 10 s let a healthy
# first phase stall on a slow host
STREAM_CHUNK = 8
LONG_FRAMES = 48
LONG_CHUNK = 16
DRILL_WATCHDOG_S = 5.0
DRILL_STALL_S = 8.0
CLI_WATCHDOG_S = 30.0
# phase 14: the second lane of the mesh batch (another seed, half the
# frames), the meshes that repeat the one card, and the worker processes
MESH_SECOND_SEED = 3
MESH_SECOND_FRAMES = 16
ONE_CARD_MESHES = ((2, 1), (1, 2), (1, 1, 2), (2, 2, 2))
MESH_WORKERS = 2
# phase 15: the serving daemon's admission bound, client threads and their
# requests, the served stream's chunk, the drill's device stall, the packed
# width, and a synthetic request at a bucket no earlier phase dispatched
# (40 frames pad to 64 at the scannet frame multiple; the mid-size cloud)
SERVE_CAPACITY = 2
SERVE_THREADS = 3
SERVE_PER_THREAD = 1
SERVE_STALL_S = 3.0
SERVE_BATCH = 2
SERVE_COLD_SPEC = {"num_boxes": 4, "num_frames": 40, "image_hw": [240, 320], "seed": 7}
# phase 17: the crash and wedge drills' heartbeat budgets, the pool's
# tenants (a weighs 3; b weighs 1 with at most 2 queued), the in-process
# order check's burst, the stall that holds the stream's second chunk in
# flight while its owner is killed, the polling period of the heartbeat
# sampler, and how much card memory a killed child may leave behind
ISO_CRASH_HB_S = 10.0
ISO_WEDGE_HB_S = 5.0
POOL_TENANTS = "a:3,b:1:2"
ORDER_BURST = {"a": 6, "b": 2}
ISO_STREAM_STALL_S = 3.0
HB_SAMPLE_S = 0.05
MEM_SLACK_MIB = 64
# phase 18: the capture's colour quality (the export's, as the JAX export
# saves), its depth shift, the export's frame skip (the JAX default, which
# the scannet config's step matches), the bilinear probe's target size, and
# a seeded probe image whose quality-95 JPEG hashes to this constant
# (tests/test_torch_preprocess.py holds PIL's bytes to the same constant,
# so the card's machine, which has no PIL, checks the encoder through it)
INGEST_QUALITY = 95
INGEST_DEPTH_SHIFT = 1000.0
INGEST_FRAME_SKIP = 10
INGEST_RESIZE_HW = (480, 640)
INGEST_SCAN = "scene0100_00"
# the exported scan's objects and digests through the CPU route, which the
# card's must equal: ``python3 chip_smoke.py --ingest-reference`` masks and
# clusters the same scan on the CPU and prints them (it takes minutes: the
# exact configuration's plain ball query)
INGEST_CPU_DIGESTS = {
    "default": {"objects": 18, "artifact": "ea15759f", "plane": "2231b89a"},
    "exact": {"objects": 23, "artifact": "b9f669d8", "plane": "0fa56ace"},
}
JPEG_PROBE_SHA256 = "1499cb8dc0cdff15ca0d935471e919a65603b6fb871b29b31f305cb0accfa903"
# phase 24: the load generator's burst over its own two buckets against
# phase 15's daemon (requests, client connections, the tenant mix), then
# phase 4's full-size scene as the one bucket: phase 10's first scan,
# requested by name with no synthetic parameters (with them the daemon
# regenerates the full-size scene on the host once to classify it); the
# children's intra-op threads, and the CPU children's
# niceness (they take the cores the script leaves idle)
LOAD_REQUESTS = 24
LOAD_CONCURRENCY = 4
LOAD_TENANT_MIX = "A:3,B:1"
LOAD_FULL_REQUESTS = 8
LOAD_FULL_CONCURRENCY = 2
LOAD_CHILD_THREADS = 2
CPU_CHILD_NICE = 19


def _adopt_orphans() -> None:
    """Make this process the child subreaper of all it starts (Linux's
    ``PR_SET_CHILD_SUBREAPER``): a process whose parent ends first (a CPU
    gate step's daemon, in a session of its own) is adopted here, so
    ``_stop_descendants`` still finds it."""
    import ctypes

    try:
        ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0)
    except (OSError, AttributeError):
        pass


def _descendants() -> list:
    """The live processes below this one, from ``/proc``."""
    kids: dict = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as fh:
                state, ppid = fh.read().rsplit(")", 1)[1].split()[:2]
        except (OSError, ValueError):
            continue
        if state != "Z":
            kids.setdefault(int(ppid), []).append(int(entry))
    found, todo = [], [os.getpid()]
    while todo:
        for pid in kids.get(todo.pop(), []):
            found.append(pid)
            todo.append(pid)
    return found


def _stop_descendants(timeout_s: float = 30.0) -> list:
    """SIGKILL every live process below this one and reap it, pass after
    pass, until none is left (the orphans of one pass are adopted by the
    next). Returns the pids it killed."""
    import signal

    killed = []
    deadline = time.monotonic() + timeout_s
    while True:
        pids = _descendants()
        for pid in pids:
            with contextlib.suppress(OSError):
                os.kill(pid, signal.SIGKILL)
        killed += pids
        while True:
            try:
                if os.waitpid(-1, os.WNOHANG)[0] == 0:
                    break
            except ChildProcessError:
                break
        if not pids or time.monotonic() > deadline:
            return killed
        time.sleep(0.05)


def _say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_ball_query_edges(dev) -> None:
    import numpy as np
    import torch

    from maskclustering_tpu_torch.ops.neighbor import ball_query, ball_query_reference
    from maskclustering_tpu_torch.ops.neighbor_cases import BALL_QUERY_CASES, ball_query_case

    for name in BALL_QUERY_CASES:
        q, c, ql, cl, k, r = ball_query_case(name)
        args = [torch.from_numpy(a).to(dev) for a in (q, c, ql, cl)]
        got = ball_query(*args, k=k, radius=r)
        want = ball_query_reference(*args, k=k, radius=r)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"ball_query kernel != plain version on '{name}': "
                                 f"{bad} slots differ")
        if not np.array_equal(want.cpu().numpy(), ball_query_reference(
                *[torch.from_numpy(a) for a in (q, c, ql, cl)], k=k, radius=r).numpy()):
            raise AssertionError(f"plain ball query differs between cuda and cpu on '{name}'")
        _say(f"  ball_query == plain on '{name}' {tuple(q.shape)}x{tuple(c.shape)} k={k}")


@contextlib.contextmanager
def recording_ball_query_groups(groups: list):
    """Keep, in ``groups``, the padded host inputs ``(q, c, ql, cl, k,
    radius)`` of every ball-query group the exact association launches
    while the context is open."""
    from maskclustering_tpu_torch.models import exact_backprojection

    launch = exact_backprojection._ball_query_group

    def record(q, c, ql, cl, k, radius, device):
        groups.append((q, c, ql, cl, k, radius))
        return launch(q, c, ql, cl, k, radius, device)

    exact_backprojection._ball_query_group = record
    try:
        yield groups
    finally:
        exact_backprojection._ball_query_group = launch


def pair_tests(out, ql, cl, k: int, s: int) -> int:
    """The pair tests these inputs need: each valid row scans candidates up
    to its k-th hit (the candidate index in slot k-1, plus one) or to the
    end of its candidates."""
    total = 0
    for bi in range(out.shape[0]):
        rows = out[bi, : max(0, min(int(ql[bi]), out.shape[1]))]
        full = rows[:, k - 1] >= 0
        total += (int((rows[full, k - 1].astype("int64") + 1).sum())
                  + int((~full).sum()) * max(0, min(int(cl[bi]), s)))
    return total


def bound_ms(ops: int, nbytes: int):
    """(least ms on the card, what bounds it) for ``ops`` FP32 operations
    moving ``nbytes``."""
    t_ops = ops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def check_and_time_groups(dev, groups):
    """Phase 5 over the scene's ball-query groups: the kernel bit-equal to
    the plain version on every group; its time at the largest group (20
    launches) beside the plain version's (1) and the bound; its time summed
    over all groups (3 launches each after one warm-up)."""
    import numpy as np
    import torch

    from maskclustering_tpu_torch.ops.cuda import BALL_QUERY_OPS_PER_PAIR, ball_query_cuda
    from maskclustering_tpu_torch.ops.neighbor import ball_query_reference

    on_card = []
    pairs_sum = bytes_sum = 0
    max_abs_err = 0.0
    for gi, (q, c, ql, cl, k, r) in enumerate(groups):
        args = [torch.from_numpy(a).to(dev) for a in (q, c, ql, cl)]
        got = ball_query_cuda(*args, k=k, radius=r)
        want = ball_query_reference(*args, k=k, radius=r)
        if not torch.equal(got, want):
            raise AssertionError(f"ball_query kernel != plain version on scene group {gi} "
                                 f"{tuple(q.shape)}x{tuple(c.shape)}: "
                                 f"{int((got != want).sum())} slots differ")
        if got.numel():
            max_abs_err = max(max_abs_err, float((got.long() - want.long()).abs().max()))
        out = want.cpu().numpy()
        pairs = pair_tests(out, ql, cl, k, c.shape[1])
        nbytes = q.nbytes + c.nbytes + ql.nbytes + cl.nbytes + out.nbytes
        pairs_sum += pairs
        bytes_sum += nbytes
        on_card.append((args, k, r, pairs, nbytes))
    # the largest group by padded shape; the heaviest in pair tests may be
    # another, and the scene sum below times every group
    big = max(range(len(groups)), key=lambda i: int(np.prod(groups[i][0].shape[:2]))
              * groups[i][1].shape[1])

    def kernel(i):
        args, k, r = on_card[i][:3]
        return lambda: ball_query_cuda(*args, k=k, radius=r)

    args, k, r, pairs, nbytes = on_card[big]
    res = {"group": big, "shape": tuple(args[0].shape[:2]) + (args[1].shape[1],),
           "ms": cuda_time_ms(kernel(big), reps=20),
           # one call: the plain version takes ~1.7 s on an H100 at this
           # group, and the check above ran it on the group already
           "plain_ms": cuda_time_ms(lambda: ball_query_reference(*args, k=k, radius=r), reps=1,
                                    warmup=0),
           "scene_ms": sum(cuda_time_ms(kernel(i), reps=3, warmup=1)
                           for i in range(len(on_card))),
           "max_abs_err": max_abs_err,
           "pair_tests": pairs, "bytes": nbytes, "scene_pair_tests": pairs_sum,
           "scene_bytes": bytes_sum}
    res["bound_ms"], res["bound_by"] = bound_ms(pairs * BALL_QUERY_OPS_PER_PAIR, nbytes)
    res["scene_bound_ms"], res["scene_bound_by"] = bound_ms(
        pairs_sum * BALL_QUERY_OPS_PER_PAIR, bytes_sum)
    return res


def check_addcmul(dev) -> int:
    """``torch.addcmul`` (the plain versions' FMA) rounds once on the card,
    as on the CPU; returns how many of a million products an unfused
    multiply-add rounds otherwise."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    a, b, c = (torch.from_numpy(rng.standard_normal(1000003).astype(np.float32))
               for _ in range(3))
    on_cpu = torch.addcmul(c, a, b)
    on_card = torch.addcmul(c.to(dev), a.to(dev), b.to(dev)).cpu()
    if not torch.equal(on_card, on_cpu):
        raise AssertionError(f"addcmul differs between cuda and cpu on "
                             f"{int((on_card != on_cpu).sum())} elements")
    return int((a * b + c != on_cpu).sum())


def _frame_tensors(case, dev):
    import numpy as np
    import torch

    t = [torch.from_numpy(np.asarray(case[k])).to(dev)
         for k in ("points", "depth", "seg", "intrinsics", "cam_to_world")]
    return (*t, torch.tensor(case["frame_valid"]).to(dev))


def _scene_tensors(case, dev):
    import numpy as np
    import torch

    return [torch.from_numpy(np.asarray(case[k])).to(dev)
            for k in ("points", "depths", "segs", "intrinsics", "cam_to_world", "frame_valid")]


ASSOCIATION_KW = ("k_max", "window", "distance_threshold", "depth_trunc", "few_points_threshold",
                  "coverage_threshold")


def check_association_edges(dev) -> None:
    """Phase 7: both scene entries bit-equal to their plain scene versions
    on the card, on every one-frame case as a scene of one frame and on the
    multi-frame cases; the frame or scene on the card equal to the CPU."""
    import torch

    from maskclustering_tpu_torch.models import backprojection as bp
    from maskclustering_tpu_torch.ops.association_cases import (
        CASES,
        SCENE_CASES,
        as_scene,
        association_case,
        association_scene_case,
    )
    from maskclustering_tpu_torch.ops.cuda import (
        associate_assign_scene_cuda,
        associate_claim_scene_cuda,
        associate_table_cuda,
    )
    from maskclustering_tpu_torch.ops.geometry import invert_se3

    cases = ([(n, association_case(n), True) for n in CASES]
             + [(n, association_scene_case(n), False) for n in SCENE_CASES])
    for name, case, one_frame in cases:
        scene = as_scene(case) if one_frame else case
        pts, depths, segs, intr, c2w, fv = _scene_tensors(scene, dev)
        prm = bp.claim_params(intr, invert_se3(c2w), distance_threshold=case["distance_threshold"],
                              depth_trunc=case["depth_trunc"])
        k_max, window = case["k_max"], case["window"]
        table = associate_table_cuda(depths, segs, prm, k_max=k_max)
        want_table = bp.pixel_table_reference(depths, segs, prm, k_max=k_max)
        n_claimed = associate_claim_scene_cuda(pts, table, prm, k_max=k_max, window=window)
        want_n = bp.claim_scene_reference(pts, table, prm, k_max=k_max, window=window)
        mask_valid = torch.rand((depths.shape[0], k_max + 1), device=dev) < 0.7
        got = associate_assign_scene_cuda(pts, table, prm, mask_valid, k_max=k_max,
                                          window=window)
        want = bp.assign_scene_reference(pts, table, prm, mask_valid, k_max=k_max, window=window)
        torch.cuda.synchronize()
        bad = [what for what, g, w in zip(
            ("table", "n_claimed", "mask_of_point", "first", "last"),
            (table, n_claimed, *got), (want_table, want_n, *want)) if not torch.equal(g, w)]
        kw = {k: case[k] for k in ASSOCIATION_KW}
        if one_frame:
            on_card = bp.associate_frame(*_frame_tensors(case, dev), None, **kw)
            on_cpu = bp.associate_frame(*_frame_tensors(case, "cpu"), None, **kw)
        else:
            on_card = bp.associate_scene(pts, depths, segs, intr, c2w, fv, **kw)
            on_cpu = bp.associate_scene(*_scene_tensors(scene, "cpu"), **kw)
        bad += [f"on cuda != cpu: {f}" for f in on_cpu._fields
                if not torch.equal(getattr(on_card, f).cpu(), getattr(on_cpu, f))]
        if bad:
            raise AssertionError(f"association kernels != plain version on '{name}': {bad}")
        _say(f"  associate_table/claim/assign == plain on '{name}' F={depths.shape[0]} "
             f"N={pts.shape[0]} HxW={tuple(depths.shape[1:])} window={window} k_max={k_max}; "
             f"{'frame' if one_frame else 'scene'} cuda == cpu")


@contextlib.contextmanager
def recording_association_frames(calls: list):
    """Keep, in ``calls``, the inputs and outputs of the scene entries
    (pixel table, claim and assignment over every frame) that the dense
    association runs while the context is open, one dict a scene, and the
    DBSCAN degrees of the post-process."""
    from maskclustering_tpu_torch.models import backprojection as bp
    from maskclustering_tpu_torch.ops import grid_dbscan as gd

    table_of, claim, assign = bp.pixel_table, bp.claim_scene, bp.assign_scene
    pack = gd.pack_neighbors

    def rec_table(depths, segs, params, *, k_max):
        table = table_of(depths, segs, params, k_max=k_max)
        calls.append({"table": (depths, segs, params, k_max), "table_out": table})
        return table

    def rec_claim(scene_points, table, params, *, k_max, window=1):
        n_claimed = claim(scene_points, table, params, k_max=k_max, window=window)
        calls[-1].update(claim=(scene_points, table, params, k_max, window), n_claimed=n_claimed)
        return n_claimed

    def rec_assign(scene_points, table, params, mask_valid, *, k_max, window=1):
        out = assign(scene_points, table, params, mask_valid, k_max=k_max, window=window)
        calls[-1].update(mask_valid=mask_valid, assigned=out)
        return out

    def rec_pack(*args, **kw):
        nb, degree = pack(*args, **kw)
        calls.append({"degree": degree.max()})
        return nb, degree

    bp.pixel_table, bp.claim_scene, bp.assign_scene = rec_table, rec_claim, rec_assign
    gd.pack_neighbors = rec_pack
    try:
        yield calls
    finally:
        bp.pixel_table, bp.claim_scene, bp.assign_scene = table_of, claim, assign
        gd.pack_neighbors = pack


def claiming_pixels(pts, depths, segs, params, *, k_max: int, window: int) -> int:
    """Window pixels of this scene that reach the claim's distance test:
    in front of the camera, in the image and the window, with a depth and
    an id (the plain claim's own tests, in torch)."""
    import torch

    from maskclustering_tpu_torch.models import backprojection as bp
    from maskclustering_tpu_torch.ops.geometry import fma, rotate

    total = 0
    h, w = depths.shape[1:]
    for f in range(depths.shape[0]):
        prm = params[f]
        cam = rotate(pts, prm[:9].reshape(3, 3)) + prm[9:12]
        in_front = cam[:, 2] > 1e-6
        safe_z = torch.where(in_front, cam[:, 2], torch.ones_like(cam[:, 2]))
        ui = bp._round_to_int32(fma(cam[:, 0] / safe_z, prm[12], prm[14].expand_as(safe_z)))
        vi = bp._round_to_int32(fma(cam[:, 1] / safe_z, prm[13], prm[15].expand_as(safe_z)))
        uc, vc = ui.clamp(0, w - 1), vi.clamp(0, h - 1)
        live = ((depths[f] > 0) & (depths[f] <= prm[17]) & (segs[f] > 0)
                & (segs[f] <= k_max)).reshape(-1)
        for dv in range(-window, window + 1):
            for du in range(-window, window + 1):
                uu, vv = uc + du, vc + dv
                ok = (in_front & (uu >= 0) & (uu < w) & (vv >= 0) & (vv < h)
                      & ((uu.long() - ui.long()).abs() <= window)
                      & ((vv.long() - vi.long()).abs() <= window))
                idx = (vv.clamp(0, h - 1) * w + uu.clamp(0, w - 1)).long()
                total += int((ok & live[idx]).sum())
    return total


def association_bounds(call):
    """The least time of each association kernel on this scene's inputs, as
    {name: (ms, bound_by, bytes, ops)}: each input of the function read
    once, each output written once, and the FP32 operations this data
    needs. The claim and the assignment are counted as functions of the
    scene's depth and id stacks, not of the pixel table they read, which
    the table's own count holds as an output."""
    from maskclustering_tpu_torch.ops.cuda import (
        CLAIM_OPS_PER_PIXEL,
        CLAIM_OPS_PER_POINT,
        TABLE_OPS_PER_PIXEL,
    )

    depths, segs, prm, k_max = call["table"]
    pts, _, _, _, window = call["claim"]
    f, n = depths.shape[0], pts.shape[0]
    maps = depths.numel() * 4 + segs.numel() * 4 + prm.numel() * 4
    table_bytes = maps + call["table_out"].numel() * 4
    table_ops = depths.numel() * TABLE_OPS_PER_PIXEL
    reads = pts.numel() * 4 + maps
    ops = (f * n * CLAIM_OPS_PER_POINT
           + claiming_pixels(pts, depths, segs, prm, k_max=k_max, window=window)
           * CLAIM_OPS_PER_PIXEL)
    claim_bytes = reads + call["n_claimed"].numel() * 4
    assign_bytes = reads + call["mask_valid"].numel() + f * n * (4 + 2 + 2)
    return {"associate_table": (*bound_ms(table_ops, table_bytes), table_bytes, table_ops),
            "associate_claim": (*bound_ms(ops, claim_bytes), claim_bytes, ops),
            "associate_assign": (*bound_ms(ops, assign_bytes), assign_bytes, ops)}


def check_and_time_scene(call):
    """Phase 8 over the scene's one call of each entry: the three kernels
    bit-equal to their plain scene versions on every frame and to what the
    main path returned, each fed the inputs the main path gave it; timed
    per scene (10 launches after a warm-up; the plain versions once after
    one), with the bound."""
    import torch

    from maskclustering_tpu_torch.models import backprojection as bp
    from maskclustering_tpu_torch.ops.cuda import (
        associate_assign_scene_cuda,
        associate_claim_scene_cuda,
        associate_table_cuda,
    )

    depths, segs, prm, k_max = call["table"]
    pts, table, _, _, window = call["claim"]
    mask_valid = call["mask_valid"]
    kw = dict(k_max=k_max, window=window)
    runs = {"associate_table": (
        lambda: (associate_table_cuda(depths, segs, prm, k_max=k_max),),
        lambda: (bp.pixel_table_reference(depths, segs, prm, k_max=k_max),)),
        "associate_claim": (
        lambda: (associate_claim_scene_cuda(pts, table, prm, **kw),),
        lambda: (bp.claim_scene_reference(pts, table, prm, **kw),)),
        "associate_assign": (
        lambda: associate_assign_scene_cuda(pts, table, prm, mask_valid, **kw),
        lambda: bp.assign_scene_reference(pts, table, prm, mask_valid, **kw))}
    main = {"associate_table": (call["table_out"],), "associate_claim": (call["n_claimed"],),
            "associate_assign": call["assigned"]}
    bounds = association_bounds(call)
    out = {}
    for name in ASSOCIATION_KERNELS:
        kernel, plain = runs[name]
        got, want = kernel(), plain()
        bad = [i for i, (g, w, m) in enumerate(zip(got, want, main[name]))
               if not (torch.equal(g, w) and torch.equal(m, w))]
        if bad:
            raise AssertionError(f"{name} != plain version on the full-size scene (outputs {bad})")
        err = max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
                  for g, w in zip(got, want))
        ms_, by, nbytes, ops = bounds[name]
        out[name] = {"ms": cuda_time_ms(kernel, reps=10),
                     "plain_ms": cuda_time_ms(plain, reps=1, warmup=1),
                     "bound_ms": ms_, "bound_by": by, "bytes": nbytes, "ops": ops,
                     "frames": depths.shape[0], "max_abs_err": float(err)}
    return out


def count_syncs(fn):
    """(``fn()``, {"file:line": times}): where ``fn`` made the host wait for
    the card, from ``torch.cuda.set_sync_debug_mode``'s warnings, each at
    the innermost frame of this repository's code."""
    import traceback
    import warnings
    from collections import Counter

    import torch

    here = os.path.dirname(os.path.abspath(__file__))
    where = Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            ours = [fr for fr in traceback.extract_stack()[:-1] if fr.filename.startswith(here)]
            fr = ours[-1] if ours else None
            where[f"{os.path.relpath(fr.filename, here)}:{fr.lineno}" if fr
                  else f"{filename}:{lineno}"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, where


def association_stage(dev, tensors, cfg, k_max: int = 63):
    """The dense association stage alone, as ``run_scene`` runs it: its
    warm wall (best of 3), its host synchronisations from the host arrays,
    and those on tensors already on the card."""
    import numpy as np
    import torch

    from maskclustering_tpu_torch.models.backprojection import (
        associate_scene,
        associate_scene_tensors,
    )
    from maskclustering_tpu_torch.models.pipeline import pad_scene_tensors
    from maskclustering_tpu_torch.utils.compile_cache import scene_pads

    padded = pad_scene_tensors(tensors, *scene_pads(cfg, tensors.num_frames,
                                                    tensors.num_points))
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        associate_scene_tensors(padded, cfg, k_max=k_max, device=dev)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    _, syncs = count_syncs(lambda: associate_scene_tensors(padded, cfg, k_max=k_max, device=dev))
    arrays = [torch.as_tensor(np.asarray(a)).to(dev) for a in (
        padded.scene_points, padded.depths, padded.segmentations, padded.intrinsics,
        padded.cam_to_world, padded.frame_valid)]
    torch.cuda.synchronize()
    _, resident = count_syncs(lambda: associate_scene(
        *arrays, k_max=k_max, window=cfg.association_window,
        distance_threshold=cfg.distance_threshold, depth_trunc=cfg.depth_trunc,
        few_points_threshold=cfg.few_points_threshold,
        coverage_threshold=cfg.coverage_threshold))
    return {"wall_s": min(walls), "walls_s": walls, "syncs": syncs, "syncs_resident": resident,
            "uploads": len(arrays)}


def dense_default_full(dev, tensors, distance_threshold: float = 0.01):
    """Phase 8: the default configuration at full size."""
    import numpy as np
    import torch

    from maskclustering_tpu_torch.config import load_config
    from maskclustering_tpu_torch.models import run_scene
    from maskclustering_tpu_torch.obs.digest import artifact_digest
    from maskclustering_tpu_torch.ops import cuda as kernels
    from maskclustering_tpu_torch.utils.compile_cache import scene_pads

    cfg = load_config("scannet", config_name="chip_smoke_dense",
                      distance_threshold=distance_threshold, post_neighbor_cap=FULL_NEIGHBOR_CAP)
    if cfg.use_exact_ball_query or not cfg.device_postprocess:
        raise AssertionError("the scannet config's default is the dense device path")
    f_pad, n_pad = scene_pads(cfg, tensors.num_frames, tensors.num_points)
    recorded = []
    with recording_association_frames(recorded):
        kernels.LAUNCHES.reset()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        res = run_scene(tensors, cfg, k_max=63, seq_name="chip_smoke_dense", device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES.counts)
    peak_mib = torch.cuda.max_memory_allocated(dev) / 2**20
    calls = [c for c in recorded if "table" in c]
    degrees = [int(c["degree"]) for c in recorded if "degree" in c]
    n_obj = len(res.objects.point_ids_list)
    digest = artifact_digest(res.objects)
    _say(f"[dense] N={tensors.num_points} N_pad={n_pad} F={tensors.num_frames} F_pad={f_pad} "
         f"M_pad={res.table.m_pad} masks={res.table.num_masks} objects={n_obj} digest={digest} "
         f"wall={wall:.2f} s peak_device_mem={peak_mib:.1f} MiB")
    _say("[dense] stage walls (s): " + json.dumps({k: round(v, 4) for k, v in res.timings.items()}))
    _say(f"[dense] DBSCAN: largest same-rep degree {max(degrees, default=0)} (post_neighbor_cap "
         f"{FULL_NEIGHBOR_CAP}, default {load_config('scannet').post_neighbor_cap})")
    _say(f"[dense] kernel launches: {json.dumps(launches)}")
    for name in ASSOCIATION_KERNELS:
        if launches.get(name, 0) != 1:
            raise AssertionError(f"{name} launched {launches.get(name, 0)} times for the scene, "
                                 f"not once")
    if launches.get("ball_query", 0):
        raise AssertionError("the dense path launched the ball query")
    if len(calls) != 1 or calls[0]["table"][0].shape[0] != f_pad:
        raise AssertionError(f"{len(calls)} scene calls kept, not one over the {f_pad} frames")
    if n_obj == 0:
        raise AssertionError("the full-size default configuration produced no objects")
    for pids in res.objects.point_ids_list:
        if pids.size == 0 or int(pids.min()) < 0 or int(pids.max()) >= tensors.num_points:
            raise AssertionError("an object holds point ids outside the scene")
    if not np.isfinite(tensors.scene_points).all():
        raise AssertionError("non-finite scene points")
    t0 = time.perf_counter()
    timed = check_and_time_scene(calls[0])
    _say(f"[kernels] associate_table/claim/assign == plain on all {f_pad} frames of the scene "
         f"({time.perf_counter() - t0:.1f} s)")
    for name, t in timed.items():
        _say(f"[kernels] {name} per scene ({t['frames']} frames, one launch): kernel "
             f"{t['ms']:.5f} ms, plain {t['plain_ms']:.3f} ms, bound {t['bound_ms']:.5f} ms "
             f"({t['bound_by']}: {t['bytes']} bytes, {t['ops']} FP32 ops), "
             f"{100 * t['bound_ms'] / t['ms']:.1f} % of the bound")
    stage = association_stage(dev, tensors, cfg)
    _say(f"[dense] association stage alone: wall {stage['wall_s']:.4f} s (best of 3: "
         + ", ".join(f"{w:.4f}" for w in stage["walls_s"])
         + f"); host syncs {sum(stage['syncs'].values())} from host arrays "
         f"({stage['uploads']} uploads) {json.dumps(stage['syncs'])}, "
         f"{sum(stage['syncs_resident'].values())} on tensors already on the card "
         f"{json.dumps(stage['syncs_resident'])}")
    profile_dense(dev, tensors, cfg, wall)
    return {"launches": launches, "timed": timed, "digest": digest, "wall": wall,
            "scene_digest": res.digest, "cfg": cfg, "m_pad": res.table.m_pad}


def busy_seconds(trace_path: str):
    """(seconds the card was busy, {kernel name: (ms, launches)}) from a
    chrome trace: the union of its kernel, copy and fill intervals."""
    from maskclustering_tpu_torch.obs.xprof import trace_busy

    busy, _, by_name = trace_busy(trace_path)
    return busy, by_name


def profile_dense(dev, tensors, cfg, wall: float) -> None:
    """Phase 8's breakdown: one more run of the default configuration under
    ``torch.profiler``, its card-busy time against that run's own wall and
    the kernels that took most of it; and the host grid build of
    the post-process's DBSCAN alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from maskclustering_tpu_torch.models import run_scene
    from maskclustering_tpu_torch.ops.grid_dbscan import build_grid

    t0 = time.perf_counter()
    build_grid(tensors.scene_points, cfg.dbscan_split_eps)
    grid_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_scene(tensors, cfg, k_max=63, seq_name="chip_smoke_dense", device=dev)
        torch.cuda.synchronize()
        profiled_wall = time.perf_counter() - t0
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "dense_trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    busy, by_name = busy_seconds(path)
    _say(f"[dense] host grid build (numpy, the DBSCAN's cell ranges): {grid_s:.4f} s")
    if not by_name:
        _say("[dense] card busy: not measured (the profiler trace holds no device events)")
        return
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    _say(f"[dense] profiled run: wall {profiled_wall:.4f} s (unprofiled {wall:.4f} s), card busy "
         f"{busy:.4f} s = {100 * busy / profiled_wall:.1f} % of its own wall, idle "
         f"{100 * (1 - busy / profiled_wall):.1f} %; "
         f"{sum(c for _, c in by_name.values())} kernel launches")
    for name, (ms, cnt) in top:
        _say(f"  {ms:10.3f} ms {cnt:7d} x {name[:110]}")
    for name, (ms, cnt) in by_name.items():
        if "scene_kernel" in name or "table_kernel" in name:
            _say(f"  association: {ms:10.4f} ms {cnt:3d} x {name[:100]}")


def dense_default_mid(dev):
    """Phase 9: the default configuration on the mid-size scene, cuda
    against cpu. Returns the two runs' digest dicts (held by phase 11)."""
    import numpy as np

    from maskclustering_tpu_torch.config import load_config
    from maskclustering_tpu_torch.models import run_scene
    from maskclustering_tpu_torch.obs.digest import artifact_digest
    from maskclustering_tpu_torch.utils.synthetic import make_scene, to_scene_tensors

    mid = to_scene_tensors(make_scene(num_boxes=4, num_frames=12, image_hw=(240, 320), seed=1))
    cfg = load_config("scannet", config_name="chip_smoke_mid_dense", distance_threshold=0.03,
                      few_points_threshold=10)
    on_card = run_scene(mid, cfg, seq_name="mid", device=dev)
    on_cpu = run_scene(mid, cfg, seq_name="mid", device="cpu")
    d_card, d_cpu = artifact_digest(on_card.objects), artifact_digest(on_cpu.objects)
    _say(f"[mid-dense] objects cuda={len(on_card.objects.point_ids_list)} "
         f"cpu={len(on_cpu.objects.point_ids_list)} digest cuda={d_card} cpu={d_cpu}")
    if d_card != d_cpu or not np.array_equal(on_card.assignment, on_cpu.assignment):
        raise AssertionError("cuda and cpu runs of the mid-size default configuration differ")
    if not on_card.objects.point_ids_list:
        raise AssertionError("the mid-size default configuration produced no objects")
    return on_card.digest, on_cpu.digest


def _tree_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(path) for f in files)


def write_scans(root: str, scene, mid_scene):
    """Phase 10's scans on disk: the full-size scene written by the port's
    writer as BATCH_SCANS[0] and copied to the other names (the writer is
    deterministic, so the copies are the files it would write), the
    mid-size one written as MID_SCAN. Returns {name: (how, seconds,
    bytes)}."""
    import shutil

    from maskclustering_tpu_torch.utils.synthetic import write_scannet_layout

    shutil.rmtree(root, ignore_errors=True)
    processed = os.path.join(root, "scannet", "processed")
    gt = os.path.join(root, "scannet", "gt")
    out = {}
    for name, sc in ((BATCH_SCANS[0], scene), (MID_SCAN, mid_scene)):
        t0 = time.perf_counter()
        write_scannet_layout(sc, root, name)
        out[name] = ("wrote", time.perf_counter() - t0)
    for name in BATCH_SCANS[1:]:
        t0 = time.perf_counter()
        shutil.copytree(os.path.join(processed, BATCH_SCANS[0]), os.path.join(processed, name))
        os.rename(os.path.join(processed, name, f"{BATCH_SCANS[0]}_vh_clean_2.ply"),
                  os.path.join(processed, name, f"{name}_vh_clean_2.ply"))
        shutil.copyfile(os.path.join(gt, f"{BATCH_SCANS[0]}.txt"), os.path.join(gt, f"{name}.txt"))
        out[name] = ("copied", time.perf_counter() - t0)
    return {name: (how, sec, _tree_bytes(os.path.join(processed, name)))
            for name, (how, sec) in out.items()}


def load_scan(root: str, name: str, scene):
    """Load one scan with ``ScanNetDataset`` and check it against the scene
    that was written, array for array, its depth quantised to millimetres
    as the writer stores it. Returns (tensors, load seconds, PNG decode
    seconds)."""
    import numpy as np

    from maskclustering_tpu_torch.datasets import get_dataset
    from maskclustering_tpu_torch.io.png import read_png

    ds = get_dataset("scannet", name, data_root=root)
    t0 = time.perf_counter()
    t = ds.load_scene_tensors(1)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for fid in t.frame_ids:
        read_png(os.path.join(ds.depth_dir, f"{fid}.png"))
        read_png(os.path.join(ds.segmentation_dir, f"{fid}.png"))
    decode_s = time.perf_counter() - t0
    mm = np.round(scene.depths * 1000.0).astype(np.uint16)
    want = {"scene_points": scene.scene_points, "segmentations": scene.segmentations,
            "depths": mm.astype(np.float32) * np.float32(1 / 1000.0),
            "intrinsics": scene.intrinsics.astype(np.float32),
            "cam_to_world": scene.cam_to_world.astype(np.float32),
            "frame_valid": np.ones(scene.depths.shape[0], bool)}
    for field, w in want.items():
        got = getattr(t, field)
        if got.dtype != w.dtype or not np.array_equal(got, w):
            raise AssertionError(f"scan {name}: loaded {field} differs from what was written")
    if t.frame_ids != list(range(scene.depths.shape[0])):
        raise AssertionError(f"scan {name}: frame ids {t.frame_ids}")
    return t, load_s, decode_s


def check_feed(dev, tensors):
    """The feed on the card: the uint16 branch engages on the loaded depth
    and its decode equals the host float32 array bit for bit. Returns
    (bytes uploaded, bytes of the float32 depth and int32 ids, {what: ms})
    with the host encode alone, the feed's whole upload and decode, and the
    plain float32/int32 upload, each best of 3 on the host clock."""
    import numpy as np
    import torch

    from maskclustering_tpu_torch.io.feed import encode_depth, encode_seg, to_device_frames

    depths, segs = tensors.depths, tensors.segmentations
    enc, scale = encode_depth(depths)
    if scale != 1000.0:
        raise AssertionError(f"the millimetre depth took the feed's {scale} branch, not 1000")
    d_dev, s_dev = to_device_frames(depths, segs, dev)
    if not (torch.equal(d_dev.cpu(), torch.from_numpy(depths))
            and torch.equal(s_dev.cpu(), torch.from_numpy(segs))):
        raise AssertionError("the feed's decode on the card differs from the host arrays")

    def best_ms(fn):
        times = []
        for _ in range(3):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize(dev)
            times.append((time.perf_counter() - t0) * 1e3)
        return min(times)

    ms = {"encode": best_ms(lambda: (encode_depth(depths), encode_seg(segs))),
          "feed": best_ms(lambda: to_device_frames(depths, segs, dev)),
          "plain": best_ms(lambda: (torch.from_numpy(np.ascontiguousarray(depths)).to(dev),
                                    torch.from_numpy(np.ascontiguousarray(segs)).to(dev)))}
    return enc.nbytes + encode_seg(segs).nbytes, depths.nbytes + segs.nbytes, ms


def paeth_decode_ms(depth_m) -> float:
    """Decode time of one 16-bit frame whose rows are all Paeth-filtered
    (best of 3, host clock), checked against the frame."""
    import numpy as np

    from maskclustering_tpu_torch.io.png import decode_png, encode_png

    mm = np.round(depth_m * 1000.0).astype(np.uint16)
    data = encode_png(mm, filters=4)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = decode_png(data)
        times.append((time.perf_counter() - t0) * 1e3)
    if not np.array_equal(out, mm):
        raise AssertionError("the Paeth frame decodes wrong")
    return min(times)


def mask_decode_ms(mask_dir: str) -> dict:
    """The id-maps of one scan as the writer gives them (PIL's adaptive row
    filters): ms a file (host clock, summed over the files) for the whole
    decode, for its row unfiltering, for the same rows through the
    wavefront alone, and for the decode of the same pixels written with
    filter 0 on every row; and the files' rows by filter type."""
    import zlib

    import numpy as np

    from maskclustering_tpu_torch.io import png

    tot = {"decode": 0.0, "unfilter": 0.0, "wavefront": 0.0, "filter0": 0.0}
    rows_by_type = np.zeros(5, np.int64)
    files = sorted(os.listdir(mask_dir))
    for f in files:
        with open(os.path.join(mask_dir, f), "rb") as fh:
            data = fh.read()
        t0 = time.perf_counter()
        img = png.decode_png(data)
        tot["decode"] += time.perf_counter() - t0
        h = img.shape[0]
        idat = b"".join(p for k, p in png._chunks(data) if k == b"IDAT")
        rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
        bpp = img.itemsize * (img.shape[2] if img.ndim == 3 else 1)
        rows_by_type += np.bincount(rows[:, 0], minlength=5)
        t0 = time.perf_counter()
        a = png.unfilter(rows, bpp)
        tot["unfilter"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        b = png._unfilter_wavefront(rows[:, 0], rows[:, 1:], bpp)
        tot["wavefront"] += time.perf_counter() - t0
        if not np.array_equal(a, b):
            raise AssertionError(f"{f}: the row decode and the wavefront differ")
        zero = png.encode_png(img)
        t0 = time.perf_counter()
        back = png.decode_png(zero)
        tot["filter0"] += time.perf_counter() - t0
        if not np.array_equal(back, img):
            raise AssertionError(f"{f}: the filter-0 copy decodes wrong")
    out = {k: 1e3 * v / len(files) for k, v in tot.items()}
    out["files"], out["rows"] = len(files), rows_by_type.tolist()
    return out


def _artifacts_equal(root: str, pred_a: str, cfg_a: str, pred_b: str, cfg_b: str,
                     names) -> None:
    """The exported npz arrays and object dicts of two runs are equal."""
    import numpy as np

    for seq in names:
        with np.load(os.path.join(pred_a, f"{cfg_a}_class_agnostic", f"{seq}.npz")) as a, \
                np.load(os.path.join(pred_b, f"{cfg_b}_class_agnostic", f"{seq}.npz")) as b:
            if sorted(a.files) != sorted(b.files) or not all(
                    a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a.files):
                raise AssertionError(f"{seq}: npz of {cfg_a} and {cfg_b} differ")
        od = os.path.join(root, "scannet", "processed", seq, "output", "object")
        oa = np.load(os.path.join(od, cfg_a, "object_dict.npy"), allow_pickle=True).item()
        ob = np.load(os.path.join(od, cfg_b, "object_dict.npy"), allow_pickle=True).item()
        if sorted(oa) != sorted(ob) or not all(
                np.array_equal(oa[k]["point_ids"], ob[k]["point_ids"])
                and oa[k]["mask_list"] == ob[k]["mask_list"]
                and oa[k]["repre_mask_list"] == ob[k]["repre_mask_list"] for k in oa):
            raise AssertionError(f"{seq}: object dicts of {cfg_a} and {cfg_b} differ")


def _ap_equal(a, b) -> bool:
    import math

    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _ap_equal(a[k], b[k]) for k in a)
    return a == b or (math.isnan(a) and math.isnan(b))


STAGES = ("associate", "graph", "cluster", "postprocess", "export")


def run_batch(dev, root: str, cfg, names, label: str):
    """``run_pipeline`` over ``names`` (cluster, eval_ca) into a prediction
    root of its own, the launch counts set to 0 just before and read just
    after; prints the scene and loop walls."""
    from maskclustering_tpu_torch.ops import cuda as kernels
    from maskclustering_tpu_torch.run import run_pipeline

    pred = os.path.join(root, f"prediction_{label}")
    kernels.LAUNCHES.reset()
    rep = run_pipeline(cfg, names, steps=("cluster", "eval_ca"), resume=False, journal=False,
                       prediction_root=pred, device=dev)
    launches = dict(kernels.LAUNCHES.counts)
    if not rep.ok or any(s.status != "ok" for s in rep.scenes):
        raise AssertionError(f"batch run {label} failed: "
                             f"{[(s.seq_name, s.status, s.error[-300:]) for s in rep.scenes]} "
                             f"{rep.step_errors}")
    loop = rep.step_seconds["cluster"]
    stage_sum = sum(s.timings.get(k, 0.0) for s in rep.scenes for k in STAGES)
    ap = rep.evaluation["eval_ca"]
    _say(f"[batch] {label}: scene walls (s) {[round(s.seconds, 3) for s in rep.scenes]}, "
         f"loop wall {loop:.3f} s, {loop / len(names):.3f} s/scene, overlap ratio "
         f"{stage_sum / loop:.3f} (stage walls {stage_sum:.3f} s / loop wall), eval_ca "
         f"{rep.step_seconds['eval_ca']:.3f} s, AP {ap['all_ap']:.4f} AP50 {ap['all_ap_50%']:.4f} "
         f"AP25 {ap['all_ap_25%']:.4f}; objects {[s.num_objects for s in rep.scenes]}, digests "
         f"{[s.digest['artifact'] for s in rep.scenes]}; launches {json.dumps(launches)}")
    _say(f"[batch] {label}: stage walls per scene (s) " + json.dumps(
        [{k: s.timings.get(k) for k in STAGES} for s in rep.scenes]))
    return rep, pred, launches


def batch_driver(dev, scene, mid_scene):
    """Phase 10: the batch driver (``run.run_pipeline``) on scans on disk."""
    from maskclustering_tpu_torch.config import load_config
    from maskclustering_tpu_torch.models import run_scene
    from maskclustering_tpu_torch.run import run_pipeline
    from maskclustering_tpu_torch.utils import faults

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_scans")
    written = write_scans(root, scene, mid_scene)
    for name, (how, sec, nbytes) in written.items():
        _say(f"[batch] {how} {name}: {nbytes} bytes in {sec:.3f} s")
    loaded = {}
    for name in BATCH_SCANS:
        t, load_s, decode_s = load_scan(root, name, scene)
        loaded[name] = t
        _say(f"[batch] loaded {name} == written: {load_s:.3f} s (PNG decode of its "
             f"{2 * t.num_frames} depth and mask files {decode_s:.3f} s)")
    up, plain, feed_ms = check_feed(dev, loaded[BATCH_SCANS[0]])
    _say(f"[batch] feed: uint16 engaged, decode on the card == host float32; h2d {up} bytes "
         f"a scan against {plain} as float32/int32 ({plain - up} saved, "
         f"{(plain - up) * len(BATCH_SCANS)} over the {len(BATCH_SCANS)} scans); host encode "
         f"{feed_ms['encode']:.2f} ms, feed upload + decode {feed_ms['feed']:.2f} ms, plain "
         f"float32/int32 upload {feed_ms['plain']:.2f} ms (best of 3)")
    _say(f"[batch] one 480x640 16-bit frame of Paeth rows decodes in "
         f"{paeth_decode_ms(scene.depths[0]):.1f} ms (host, best of 3)")
    md = mask_decode_ms(os.path.join(root, "scannet", "processed", BATCH_SCANS[0], "output",
                                     "mask"))
    _say(f"[batch] {BATCH_SCANS[0]}'s {md['files']} id-maps (PIL's row filters, rows by type "
         f"None/Sub/Up/Average/Paeth {md['rows']}): decode {md['decode']:.2f} ms a file, of it "
         f"unfiltering {md['unfilter']:.2f} ms; the same rows through the wavefront alone "
         f"{md['wavefront']:.2f} ms; the pixels as filter-0 rows decode in {md['filter0']:.2f} ms "
         f"(host clock, mean over the files)")

    # the three full-size scans, overlapped and sequential
    # step 1: the synthetic scan's 32 frames stand for a real scan's step-10 frames
    base = load_config("scannet", data_root=root, step=1, distance_threshold=0.01,
                       post_neighbor_cap=FULL_NEIGHBOR_CAP)
    ov_cfg = base.replace(config_name="chip_smoke_overlap")
    sq_cfg = base.replace(config_name="chip_smoke_sequential", scene_overlap=False)
    ov, ov_pred, launches = run_batch(dev, root, ov_cfg, BATCH_SCANS, "overlapped")
    sq, sq_pred, sq_launches = run_batch(dev, root, sq_cfg, BATCH_SCANS, "sequential")
    for name in ASSOCIATION_KERNELS:
        for lab, counts in (("overlapped", launches), ("sequential", sq_launches)):
            if counts.get(name, 0) != len(BATCH_SCANS):
                raise AssertionError(f"{name} launched {counts.get(name, 0)} times in the "
                                     f"{lab} run of {len(BATCH_SCANS)} scans, not once a scene")
    if launches.get("ball_query", 0) or sq_launches.get("ball_query", 0):
        raise AssertionError("the batch driver's dense path launched the ball query")
    _artifacts_equal(root, ov_pred, ov_cfg.config_name, sq_pred, sq_cfg.config_name,
                     BATCH_SCANS)
    if not _ap_equal(ov.evaluation["eval_ca"], sq.evaluation["eval_ca"]):
        raise AssertionError("the AP of the overlapped and sequential runs differ")
    ref = run_scene(loaded[BATCH_SCANS[0]], ov_cfg, device=dev).digest
    for st, st_sq in zip(ov.scenes, sq.scenes):
        if st.digest != st_sq.digest or st.digest != ref:
            raise AssertionError(f"{st.seq_name}: digests {st.digest} / {st_sq.digest}, "
                                 f"run_scene on the loaded scan {ref}")
    if not all(s.num_objects > 0 for s in ov.scenes):
        raise AssertionError("a full-size scan produced no objects")
    _say(f"[batch] overlapped == sequential (npz, object dicts, AP); every digest == run_scene "
         f"on the loaded scan ({json.dumps(ref)}); each association entry launched once a "
         f"scene")

    # the mid-size scan on the card and on the CPU
    mid = {}
    for d in (dev, "cpu"):
        cfg = load_config("scannet", data_root=root, step=1, distance_threshold=0.03,
                          few_points_threshold=10,
                          config_name=f"chip_smoke_mid_{str(d).split(':')[0]}")
        mid[str(d)] = (cfg, *run_batch(d, root, cfg, [MID_SCAN], f"mid-{d}")[:2])
    (c_cfg, c_rep, c_pred), (h_cfg, h_rep, h_pred) = mid[str(dev)], mid["cpu"]
    _artifacts_equal(root, c_pred, c_cfg.config_name, h_pred, h_cfg.config_name, [MID_SCAN])
    if (c_rep.scenes[0].digest != h_rep.scenes[0].digest
            or not _ap_equal(c_rep.evaluation["eval_ca"], h_rep.evaluation["eval_ca"])
            or c_rep.scenes[0].num_objects == 0):
        raise AssertionError("the mid-size scan differs between cuda and cpu")
    _say(f"[batch] mid-size scan: cuda == cpu (npz, object dicts, AP, digest "
         f"{c_rep.scenes[0].digest['artifact']})")

    # the ladder drill: the default neighbour cap overflows the full-size scan
    cap = load_config("scannet").post_neighbor_cap
    ladder_cfg = base.replace(config_name="chip_smoke_ladder", post_neighbor_cap=cap)
    journal = os.path.join(root, "ladder_journal.jsonl")
    t0 = time.perf_counter()
    rep = run_pipeline(ladder_cfg, BATCH_SCANS[:1], steps=("cluster",), resume=False,
                       journal_path=journal, prediction_root=os.path.join(root, "prediction_ladder"),
                       device=dev)
    wall = time.perf_counter() - t0
    (st,) = rep.scenes
    rows = [r for r in faults.read_journal(journal) if r.get("event") == "outcome"]
    for i, r in enumerate(rows):
        _say(f"[ladder] attempt {i + 1}: rung {r['rung']}, {r['status']}, {r['seconds']} s"
             + (f", {r['error_class']}: {r.get('error', '')}" if r["status"] != "ok" else ""))
    _say(f"[ladder] post_neighbor_cap {cap}: {st.status} after {st.attempts} attempts on rung "
         f"{st.degradation_rung} ({'+'.join(rep.faults['degradations'])}), wall {wall:.2f} s, "
         f"digest {st.digest}")
    if (st.status, st.attempts, st.degradation_rung) != ("ok", 3, 2) or list(
            rep.faults["degradations"]) != ["sequential-executor", "host-postprocess"]:
        raise AssertionError("the ladder drill did not heal on the host-postprocess rung "
                             "at the third attempt")
    if st.digest != ov.scenes[0].digest:
        raise AssertionError(f"host rung digest {st.digest} != device rung {ov.scenes[0].digest}")
    _artifacts_equal(root, os.path.join(root, "prediction_ladder"), ladder_cfg.config_name,
                     ov_pred, ov_cfg.config_name, BATCH_SCANS[:1])
    _say("[ladder] host-postprocess rung == device rung at cap 1024 (npz, object dict)")
    return {"launches": launches, "root": root, "cfg": ov_cfg, "pred": ov_pred,
            "ap": ov.evaluation["eval_ca"], "cluster_s": ov.step_seconds["cluster"],
            "scans": {s.seq_name: (s.digest, s.num_objects) for s in ov.scenes},
            "scene_seconds": {s.seq_name: s.seconds for s in ov.scenes}}


def textured_frame(seg, frame: int, seed: int = 0):
    """A seeded textured colour frame at ScanNet's colour size: the id-map
    nearest-resized to 968x1296 as flat seeded colours, a smooth shading and
    seeded noise (sigma 5), which at quality 90 gives about 1.5 bits a pixel,
    a photo's coefficient density."""
    import numpy as np

    from maskclustering_tpu_torch.io.image import resize_nearest

    h, w = COLOR_HW
    rng = np.random.default_rng([seed, frame])
    big = resize_nearest(seg, (w, h))
    palette = rng.integers(40, 216, (int(seg.max()) + 1, 3)).astype(np.float32)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    shade = 18.0 * np.sin(x / 41.0 + frame) * np.cos(y / 29.0 - frame)
    img = palette[big] + shade[..., None] + rng.normal(0.0, 5.0, (h, w, 3)).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def write_color_frames(root: str, names, scene):
    """Rewrite the scans' colour frames as textured 968x1296 JPEGs (quality
    90, 4:2:0) through the port's encoder; the scans are one scene under
    several names, so each frame is encoded once. Returns (seconds, bytes a
    frame)."""
    from maskclustering_tpu_torch.io.jpeg import encode_jpeg

    t0 = time.perf_counter()
    sizes = []
    for f in range(scene.segmentations.shape[0]):
        data = encode_jpeg(textured_frame(scene.segmentations[f], f), COLOR_QUALITY)
        sizes.append(len(data))
        for name in names:
            with open(os.path.join(root, "scannet", "processed", name, "color", f"{f}.jpg"),
                      "wb") as fh:
                fh.write(data)
    return time.perf_counter() - t0, sum(sizes) / len(sizes)


def jpeg_decode_ms(path: str) -> float:
    """Decode time of one colour frame through ``read_rgb`` (host, best of 3)."""
    from maskclustering_tpu_torch.io.image import read_rgb

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        rgb = read_rgb(path)
        times.append((time.perf_counter() - t0) * 1e3)
    if rgb.shape != COLOR_HW + (3,):
        raise AssertionError(f"{path} decodes to {rgb.shape}")
    return min(times)


# the CPU references of phases 11 and 13 and the scenes of 13c and 14 run in
# this many spawned processes from the end of phase 8, beside phases 9-12,
# each with this many threads at this niceness
CPU_REF_THREADS = 2
CPU_REF_NICE = 10
CPU_REF_PROCESSES = 3


def _cpu_ref_init() -> None:
    """A CPU-reference child: no card visible, few threads, low priority."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    os.environ["OMP_NUM_THREADS"] = str(CPU_REF_THREADS)
    here = os.path.dirname(os.path.abspath(__file__))
    if here not in sys.path:
        sys.path.insert(0, here)
    os.nice(CPU_REF_NICE)
    import torch

    torch.set_num_threads(CPU_REF_THREADS)


def start_cpu_references(tensors, cfg):
    """Phases 11a's and 13b's CPU runs, 13c's longer scene and 14's second
    scene, submitted at the end of phase 8 to a pool of spawned processes
    (11b's CPU run takes the first free one once its colour frames exist);
    their phases read the futures."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    pool = ProcessPoolExecutor(CPU_REF_PROCESSES,
                               mp_context=multiprocessing.get_context("spawn"),
                               initializer=_cpu_ref_init)
    return {"pool": pool, "digest": pool.submit(_digest_cpu_reference, tensors, cfg),
            "stream": pool.submit(_stream_cpu_reference, tensors,
                                  cfg.replace(streaming_chunk=STREAM_CHUNK,
                                              config_name="chip_smoke_stream")),
            "long": pool.submit(_long_scene_tensors),
            "second": pool.submit(_mesh_second_tensors)}


def _digest_cpu_reference(tensors, cfg):
    """Phase 11a's cpu run of phase 8's scene (in the CPU-reference child):
    (digest, seconds, stage walls). It takes the host post-process rung: the
    plane lane reads only the device phase, and both rungs give the same
    digest dict (the tests hold them equal); the device rung's plain torch
    DBSCAN is the slow part of a full-size scene on the host."""
    from maskclustering_tpu_torch.models import run_scene

    t0 = time.perf_counter()
    res = run_scene(tensors, cfg.replace(device_postprocess=False), k_max=63,
                    seq_name="chip_smoke_dense", device="cpu")
    return res.digest, time.perf_counter() - t0, res.timings


def _stream_cpu_reference(tensors, cfg8):
    """Phase 13b's four-chunk stream on the cpu (in the CPU-reference
    child): its chunk dicts, digest, assignment, artifact digest, wall and
    timings."""
    from maskclustering_tpu_torch.models.streaming import stream_scene
    from maskclustering_tpu_torch.obs.digest import artifact_digest

    records = []
    with recording_stream_chunks(records):
        t0 = time.perf_counter()
        res = stream_scene(tensors, cfg8, seq_name="chip_smoke_stream", device="cpu")
        wall = time.perf_counter() - t0
    return {"chunks": _stream_chunks(records), "digest": res.digest,
            "assignment": res.assignment, "artifact": artifact_digest(res.objects),
            "wall": wall, "timings": res.timings}


def _semantic_cpu_reference(cfg, names, prediction_root):
    """Phase 11b's semantic steps on the cpu (in the CPU-reference child):
    (step seconds, the class-aware AP table)."""
    from maskclustering_tpu_torch.run import run_pipeline

    rep = run_pipeline(cfg, names, steps=SEMANTIC_STEPS, resume=False, journal=False,
                       prediction_root=prediction_root, encoder_spec=SEMANTIC_ENCODER,
                       device="cpu")
    if not rep.ok:
        raise AssertionError(f"semantic steps on cpu failed: {rep.step_errors}")
    return rep.step_seconds, rep.evaluation["eval"]


def plane_digest_lane(dev, tensors, dense, mid_digests, cpu_refs) -> None:
    """Phase 11a: the plane lane. Phase 8's full-size scene on cuda against
    a cpu run (in the CPU-reference child), full digest dicts; phase 9's
    mid-size dicts; the digest program and its pull timed on the card."""
    import torch

    from maskclustering_tpu_torch.models.pipeline import run_scene_device
    from maskclustering_tpu_torch.obs.digest import digest_scene_device, vector_host

    cfg = dense["cfg"]
    t0 = time.perf_counter()
    cpu_digest, cpu_s, cpu_timings = cpu_refs["digest"].result(timeout=900)
    _say(f"[digest] full-size scene: cuda {json.dumps(dense['scene_digest'])}, cpu "
         f"{json.dumps(cpu_digest)} (cpu run, host post-process rung, {cpu_s:.1f} s in the "
         f"CPU-reference child from the end of phase 8, {time.perf_counter() - t0:.1f} s of it "
         f"waited for; stage walls "
         f"{json.dumps({k: round(v, 3) for k, v in cpu_timings.items()})})")
    if not dense["scene_digest"]["plane"] or dense["scene_digest"] != cpu_digest:
        raise AssertionError("the full-size scene's digest differs between cuda and cpu")
    card, cpu = mid_digests
    _say(f"[digest] mid-size scene: cuda {json.dumps(card)}, cpu {json.dumps(cpu)}")
    if not card["plane"] or card != cpu:
        raise AssertionError("the mid-size scene's digest differs between cuda and cpu")
    handoff = run_scene_device(tensors, cfg, k_max=63, device=dev)
    program_ms = cuda_time_ms(lambda: digest_scene_device(handoff), reps=20)
    pulls = []
    for _ in range(5):
        vec = digest_scene_device(handoff)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        vector_host(vec)
        pulls.append((time.perf_counter() - t0) * 1e3)
    f_pad, n_pad = handoff.first_id.shape
    _say(f"[digest] scene digest program on the card: {program_ms:.4f} ms (CUDA events, mean of "
         f"20) over ({f_pad}, {n_pad}) int16 claim planes, M_pad {handoff.table.m_pad}; its "
         f"(8,) pull {min(pulls):.4f} ms (host clock, best of 5)")


def semantic_steps(dev, scene, batch, cpu_refs) -> None:
    """Phase 11b: features, label_features, query and eval over phase 10's
    first full-size scan, its colour frames rewritten at 968x1296, on cuda
    and on cpu (in the CPU-reference child, beside the cuda run); equal
    features, class-aware npz and AP."""
    import shutil

    import numpy as np

    from maskclustering_tpu_torch.run import run_pipeline
    from maskclustering_tpu_torch.semantics import representative_mask_index

    root, cfg, pred = batch["root"], batch["cfg"], batch["pred"]
    names = BATCH_SCANS[:1]
    sec, per_frame = write_color_frames(root, names, scene)
    color0 = os.path.join(root, "scannet", "processed", BATCH_SCANS[0], "color", "0.jpg")
    _say(f"[semantic] wrote {scene.segmentations.shape[0]} textured {COLOR_HW[0]}x{COLOR_HW[1]} "
         f"JPEG frames (quality {COLOR_QUALITY}, 4:2:0, {per_frame:.0f} bytes a frame) into "
         f"{len(names)} scan in {sec:.1f} s; one frame decodes in "
         f"{jpeg_decode_ms(color0):.1f} ms (host, best of 3)")
    od = {name: np.load(os.path.join(root, "scannet", "processed", name, "output", "object",
                                     cfg.config_name, "object_dict.npy"),
                        allow_pickle=True).item() for name in names}
    frames = {name: len({f for f, _ in representative_mask_index(od[name])})
              for name in names}

    def semantic_run(run_cfg, names, prediction_root, device):
        rep = run_pipeline(run_cfg, names, steps=SEMANTIC_STEPS, resume=False, journal=False,
                           prediction_root=prediction_root, encoder_spec=SEMANTIC_ENCODER,
                           device=device)
        if not rep.ok:
            raise AssertionError(f"semantic steps on {device} failed: {rep.step_errors}")
        return rep

    cpu_cfg = cfg.replace(config_name="chip_smoke_semantic_cpu")
    obj_dir = os.path.join(root, "scannet", "processed", BATCH_SCANS[0], "output", "object")
    os.makedirs(os.path.join(obj_dir, cpu_cfg.config_name), exist_ok=True)
    shutil.copy(os.path.join(obj_dir, cfg.config_name, "object_dict.npy"),
                os.path.join(obj_dir, cpu_cfg.config_name, "object_dict.npy"))
    cpu_pred = os.path.join(root, "prediction_semantic_cpu")
    cpu_job = cpu_refs["pool"].submit(_semantic_cpu_reference, cpu_cfg, names, cpu_pred)
    card = semantic_run(cfg, names, pred, dev)
    t0 = time.perf_counter()
    cpu_seconds, cpu_eval = cpu_job.result(timeout=900)
    _say(f"[semantic] cuda over {len(names)} scan (encoder {SEMANTIC_ENCODER}): step "
         f"seconds {json.dumps({k: round(v, 3) for k, v in card.step_seconds.items()})}; "
         f"distinct colour frames decoded {json.dumps(frames)} "
         f"(of {scene.segmentations.shape[0]} a scan)")
    _say(f"[semantic] cpu over {BATCH_SCANS[0]} (the CPU-reference child, beside the cuda run; "
         f"{time.perf_counter() - t0:.1f} s waited for): step seconds "
         f"{json.dumps({k: round(v, 3) for k, v in cpu_seconds.items()})}")

    name = BATCH_SCANS[0]
    feats = {}
    for c in (cfg.config_name, cpu_cfg.config_name):
        feats[c] = np.load(os.path.join(obj_dir, c, "open-vocabulary_features.npy"),
                           allow_pickle=True).item()
    a, b = feats[cfg.config_name], feats[cpu_cfg.config_name]
    if list(a) != list(b) or not a or not all(
            a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a):
        raise AssertionError(f"{name}: the features of the cuda and cpu runs differ")
    if any(v.shape != (1024,) or not np.isfinite(v).all() for v in a.values()):
        raise AssertionError(f"{name}: features not finite (1024,) vectors")
    with np.load(os.path.join(pred, cfg.config_name, f"{name}.npz")) as x, \
            np.load(os.path.join(cpu_pred, cpu_cfg.config_name, f"{name}.npz")) as y:
        if sorted(x.files) != sorted(y.files) or not all(
                x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]) for k in x.files):
            raise AssertionError(f"{name}: the class-aware npz of the cuda and cpu runs differ")
        if x["pred_masks"].shape != (scene.scene_points.shape[0], len(od[name])):
            raise AssertionError(f"{name}: pred_masks {x['pred_masks'].shape}")
        classes = x["pred_classes"].tolist()
    if not _ap_equal(card.evaluation["eval"], cpu_eval):
        raise AssertionError(f"{name}: the class-aware AP of the cuda and cpu runs differ")
    ap = card.evaluation["eval"]
    _say(f"[semantic] {name}: cuda == cpu (features {len(a)} x 1024 bit for bit, class-aware "
         f"npz, AP table); classes {classes}; AP {ap['all_ap']:.4f} AP50 "
         f"{ap['all_ap_50%']:.4f} (hash features: classes at random)")


def vit_h14_state_dict(seed: int):
    """open_clip ViT-H-14 weights (classic layout) drawn from a seeded
    generator: matrices and embeddings N(0, 0.02), LayerNorm weights 1 +
    N(0, 0.02) and biases N(0, 0.02), so 32 and 24 pre-LN blocks stay well
    conditioned."""
    import torch

    g = torch.Generator().manual_seed(seed)
    vis, txt = VIT_H14["vision_cfg"], VIT_H14["text_cfg"]
    vw, tw, embed = vis["width"], txt["width"], VIT_H14["embed_dim"]
    patch, grid = vis["patch_size"], vis["image_size"] // vis["patch_size"]

    def rand(*shape):
        return torch.randn(*shape, generator=g) * 0.02

    sd = {"visual.class_embedding": rand(vw),
          "visual.positional_embedding": rand(grid * grid + 1, vw),
          "visual.conv1.weight": rand(vw, 3, patch, patch),
          "visual.proj": rand(vw, embed),
          "token_embedding.weight": rand(txt["vocab_size"], tw),
          "positional_embedding": rand(txt["context_length"], tw),
          "text_projection": rand(tw, embed),
          "logit_scale": torch.tensor(4.6052)}
    for name, w in (("visual.ln_pre", vw), ("visual.ln_post", vw), ("ln_final", tw)):
        sd[name + ".weight"], sd[name + ".bias"] = 1 + rand(w), rand(w)
    for root, w, layers in (("visual.transformer", vw, vis["layers"]),
                            ("transformer", tw, txt["layers"])):
        mlp = int(w * 4)
        for i in range(layers):
            p = f"{root}.resblocks.{i}."
            sd[p + "ln_1.weight"], sd[p + "ln_1.bias"] = 1 + rand(w), rand(w)
            sd[p + "ln_2.weight"], sd[p + "ln_2.bias"] = 1 + rand(w), rand(w)
            sd[p + "attn.in_proj_weight"], sd[p + "attn.in_proj_bias"] = rand(3 * w, w), rand(3 * w)
            sd[p + "attn.out_proj.weight"], sd[p + "attn.out_proj.bias"] = rand(w, w), rand(w)
            sd[p + "mlp.c_fc.weight"], sd[p + "mlp.c_fc.bias"] = rand(mlp, w), rand(mlp)
            sd[p + "mlp.c_proj.weight"], sd[p + "mlp.c_proj.bias"] = rand(w, mlp), rand(w)
    return sd


def write_byte_level_tokenizer(path: str, words, n_merges: int) -> int:
    """vocab.json and merges.txt of a CLIP byte-level BPE: the 256 byte
    symbols, their ``</w>`` forms, the ``n_merges`` most frequent pairs of
    ``words`` (learned greedily) and the two special tokens. Returns the
    vocabulary size."""
    import collections

    from maskclustering_tpu_torch.semantics.tokenizer import bytes_to_unicode

    b2u = bytes_to_unicode()
    vocab = list(b2u.values()) + [c + "</w>" for c in b2u.values()]
    counts = collections.Counter()
    for w in words:
        chars = [b2u[b] for b in w.encode()]
        chars[-1] += "</w>"
        counts[tuple(chars)] += 1
    merges = []
    for _ in range(n_merges):
        pairs = collections.Counter()
        for w, c in counts.items():
            for pair in zip(w, w[1:]):
                pairs[pair] += c
        if not pairs:
            break
        (a, b), _ = pairs.most_common(1)[0]
        merges.append(f"{a} {b}")
        vocab.append(a + b)
        merged = collections.Counter()
        for w, c in counts.items():
            out, i = [], 0
            while i < len(w):
                if i + 1 < len(w) and (w[i], w[i + 1]) == (a, b):
                    out.append(a + b)
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            merged[tuple(out)] += c
        counts = merged
    vocab += ["<|startoftext|>", "<|endoftext|>"]
    with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump({t: i for i, t in enumerate(vocab)}, f)
    with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(merges) + "\n")
    return len(vocab)


def write_clip_checkpoint(path: str):
    """Phase 12a: ViT-H-14 in the open_clip layout with its tokenizer and
    preprocessor. Returns (seconds to draw, seconds to write, bytes)."""
    import shutil

    import torch

    from maskclustering_tpu_torch.semantics import get_vocab

    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    t0 = time.perf_counter()
    sd = vit_h14_state_dict(CLIP_SEED)
    draw_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    torch.save(sd, os.path.join(path, "open_clip_pytorch_model.bin"))
    with open(os.path.join(path, "open_clip_config.json"), "w") as f:
        json.dump({"model_cfg": VIT_H14}, f)
    words = [w for label in get_vocab("scannet")[0] for w in label.lower().split()]
    n_vocab = write_byte_level_tokenizer(path, words, CLIP_MERGES)
    if n_vocab > VIT_H14["text_cfg"]["vocab_size"]:
        raise AssertionError(f"{n_vocab} tokens do not fit the embedding")
    with open(os.path.join(path, "preprocessor_config.json"), "w") as f:
        json.dump({"size": {"shortest_edge": 224}, "crop_size": {"height": 224, "width": 224},
                   "resample": 3, "rescale_factor": 1 / 255,
                   "image_mean": [0.48145466, 0.4578275, 0.40821073],
                   "image_std": [0.26862954, 0.26130258, 0.27577711]}, f)
    return draw_s, time.perf_counter() - t0, _tree_bytes(path)


def tower_flops(tokens: int, width: int, mlp: int, layers: int) -> int:
    """FP32 operations of ``layers`` pre-LN blocks over ``tokens`` tokens, an
    FMA counted as two: q, k, v and out (8 T D^2), the scores and their
    product with v (4 T^2 D), the MLP (4 T D M)."""
    return layers * (8 * tokens * width ** 2 + 4 * tokens ** 2 * width + 4 * tokens * width * mlp)


def clip_encoder(dev, scene, batch) -> None:
    """Phase 12: the CLIP encoder at ViT-H-14's full width on cuda against
    cpu, timed beside its FP32 bound, then through the semantic steps."""
    import shutil

    import numpy as np
    import torch

    from maskclustering_tpu_torch import run as run_module
    from maskclustering_tpu_torch.io.image import read_rgb
    from maskclustering_tpu_torch.run import run_pipeline
    from maskclustering_tpu_torch.semantics import HFCLIPEncoder, get_vocab, multiscale_crops

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(here, "build", "chip_smoke_clip")
    draw_s, write_s, nbytes = write_clip_checkpoint(path)
    t0 = time.perf_counter()
    card = HFCLIPEncoder(path, device=dev)
    torch.cuda.synchronize(dev)
    load_card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = HFCLIPEncoder(path, device="cpu")
    load_cpu_s = time.perf_counter() - t0
    spec = card.model.spec
    n_params = sum(p.numel() for p in card.model.parameters())
    if not all(p.device.type == "cuda" for p in card.model.parameters()):
        raise AssertionError("the cuda encoder's weights are not all on the card")
    _say(f"[clip] ViT-H-14 open_clip checkpoint: {n_params} parameters, {nbytes} bytes in "
         f"{path} (drawn in {draw_s:.1f} s, written in {write_s:.1f} s); loaded to cuda in "
         f"{load_card_s:.1f} s, to cpu in {load_cpu_s:.1f} s; spec {json.dumps(spec.to_dict())}")

    # 12b: crops of phase 11's textured frames and labels, cuda against cpu
    frame = read_rgb(os.path.join(batch["root"], "scannet", "processed", BATCH_SCANS[0],
                                  "color", "0.jpg"))
    seg = scene.segmentations[0]
    crops = []
    for mask_id in sorted(set(np.unique(seg).tolist()) - {0}):
        crops += multiscale_crops(frame, seg == mask_id)
    crops = crops[:CLIP_CROPS]
    labels = list(get_vocab("scannet")[0][:CLIP_LABELS])
    if len(crops) != CLIP_CROPS:
        raise AssertionError(f"{len(crops)} crops cut from frame 0")
    t0 = time.perf_counter()
    img_card, txt_card = card.encode_images(crops), card.encode_texts(labels)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    img_cpu, txt_cpu = host.encode_images(crops), host.encode_texts(labels)
    cpu_s = time.perf_counter() - t0
    for name, a, b in (("image", img_card, img_cpu), ("text", txt_card, txt_cpu)):
        err = float(np.abs(a - b).max())
        cos = float((a * b).sum(axis=1).min())
        _say(f"[clip] {name} features {a.shape} cuda vs cpu: max abs difference {err:.3e}, "
             f"least cosine {cos:.9f} (tolerance {CLIP_TOLERANCE:g})")
        if not (np.isfinite(a).all() and np.isfinite(b).all()) or err > CLIP_TOLERANCE:
            raise AssertionError(f"{name} features differ between cuda and cpu by {err}")
    _say(f"[clip] {CLIP_CROPS} crops ({[c.shape[0] for c in crops]} px squares) and "
         f"{CLIP_LABELS} labels encoded in {card_s:.2f} s on cuda, {cpu_s:.2f} s on cpu "
         f"(host clock, preprocessing and tokenising included)")

    t0 = time.perf_counter()
    card.processor(crops)
    prep_ms = (time.perf_counter() - t0) * 1e3 / len(crops)
    _say(f"[clip] host preprocessing (PIL-equal bicubic resize, crop, normalise): "
         f"{prep_ms:.2f} ms a crop over the {len(crops)} crops (host clock)")

    # the towers timed on the card (CUDA events), beside their FP32 bounds
    pixels = torch.from_numpy(card.processor(crops * (CLIP_BATCH // CLIP_CROPS))).to(dev)
    tokens = card.tokenizer(labels)
    ids = torch.from_numpy(tokens["input_ids"]).to(dev)
    mask = torch.from_numpy(tokens["attention_mask"]).to(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.inference_mode():
        image_ms = cuda_time_ms(lambda: card.model.get_image_features(pixels), reps=3,
                                warmup=1) / CLIP_BATCH
        text_ms = cuda_time_ms(lambda: card.model.get_text_features(ids, mask), reps=10,
                               warmup=2) / CLIP_LABELS
    peak_mib = torch.cuda.max_memory_allocated(dev) / 2**20
    patches = spec.num_patches
    image_ops = (2 * patches * spec.num_channels * spec.patch_size ** 2 * spec.vision_width
                 + tower_flops(patches + 1, spec.vision_width, spec.vision_mlp,
                               spec.vision_layers)
                 + 2 * spec.vision_width * spec.projection_dim)
    lengths = tokens["attention_mask"].sum(axis=1).tolist()
    image_bytes = (sum(p.numel() for p in card.model.vision_model.parameters())
                   + card.model.visual_projection.weight.numel()) * 4 / CLIP_BATCH \
        + (3 * 224 * 224 + spec.projection_dim) * 4
    text_ops = sum(tower_flops(n, spec.text_width, spec.text_mlp, spec.text_layers)
                   + 2 * spec.text_width * spec.projection_dim for n in lengths) / CLIP_LABELS
    # the text tower's weights but the token table, of which each token reads one row
    table = card.model.text_model.embeddings.token_embedding.weight
    text_bytes = (sum(p.numel() for p in card.model.text_model.parameters()) - table.numel()
                  + card.model.text_projection.weight.numel()) * 4 / CLIP_LABELS \
        + (sum(lengths) / CLIP_LABELS) * (spec.text_width * 4 + 8) + spec.projection_dim * 4
    for name, ms, ops, nb, unit in (("image", image_ms, image_ops, image_bytes, "crop"),
                                    ("text", text_ms, text_ops, text_bytes, "label")):
        bound, by = bound_ms(int(ops), int(nb))
        _say(f"[clip] {name} tower: {ms:.4f} ms a {unit} (CUDA events; batch "
             f"{CLIP_BATCH if name == 'image' else CLIP_LABELS}), FP32 bound {bound:.4f} ms "
             f"({by}: {ops / 1e9:.3f} GFLOP, {nb / 1e6:.3f} MB a {unit}), "
             f"{100 * bound / ms:.1f} % of the bound")
    _say(f"[clip] peak device memory over the timed batches {peak_mib:.1f} MiB; label token "
         f"counts {lengths}")
    del host

    # 12c: the semantic steps with the CLIP encoder on the card, one scan
    root, cfg = batch["root"], batch["cfg"]
    clip_cfg = cfg.replace(config_name="chip_smoke_clip")
    obj_dir = os.path.join(root, "scannet", "processed", BATCH_SCANS[0], "output", "object")
    os.makedirs(os.path.join(obj_dir, clip_cfg.config_name), exist_ok=True)
    shutil.copy(os.path.join(obj_dir, cfg.config_name, "object_dict.npy"),
                os.path.join(obj_dir, clip_cfg.config_name, "object_dict.npy"))
    pred = os.path.join(root, "prediction_clip")
    built = []
    make_encoder = run_module.make_encoder

    def recording_make_encoder(spec_str, device=None):
        built.append(make_encoder(spec_str, device))
        return built[-1]

    # phase 11's hash label features at this path are rewritten with CLIP's
    text_path = os.path.join(root, "text_features", "scannet.npy")
    run_module.make_encoder = recording_make_encoder
    try:
        rep = run_pipeline(clip_cfg, BATCH_SCANS[:1], steps=SEMANTIC_STEPS, resume=False,
                           journal=False, prediction_root=pred, encoder_spec=f"hf:{path}",
                           device=dev)
    finally:
        run_module.make_encoder = make_encoder
    if not rep.ok:
        raise AssertionError(f"semantic steps with the CLIP encoder failed: {rep.step_errors}")
    if len(built) != 1 or not all(p.device.type == "cuda"
                                  for p in built[0].model.parameters()):
        raise AssertionError("the driver's CLIP encoder is not on the card")
    feats = np.load(os.path.join(obj_dir, clip_cfg.config_name, "open-vocabulary_features.npy"),
                    allow_pickle=True).item()
    norms = np.array([np.linalg.norm(v) for v in feats.values()])
    if not feats or any(v.shape != (spec.projection_dim,) or v.dtype != np.float32
                        or not np.isfinite(v).all() for v in feats.values()) \
            or not ((norms > 0) & (norms <= 1 + 1e-5)).all():
        raise AssertionError("CLIP mask features are not finite 1024-wide means of unit vectors")
    label_feats = np.load(text_path, allow_pickle=True).item()
    label_names, label_ids = get_vocab("scannet")
    lf = np.stack([label_feats[k] for k in label_names])
    if list(label_feats) != list(label_names) or lf.shape != (198, spec.projection_dim) \
            or not np.allclose(np.linalg.norm(lf, axis=1), 1.0, atol=1e-5):
        raise AssertionError(f"label features {lf.shape} are not 198 unit 1024-vectors")
    with np.load(os.path.join(pred, clip_cfg.config_name, f"{BATCH_SCANS[0]}.npz")) as x:
        classes = x["pred_classes"].tolist()
    if not set(classes) <= set(label_ids):
        raise AssertionError(f"classes {classes} outside the vocabulary's ids")
    ap = rep.evaluation["eval"]
    _say(f"[clip] semantic steps on cuda with hf:{os.path.relpath(path, here)} over "
         f"{BATCH_SCANS[0]}: step seconds "
         f"{json.dumps({k: round(v, 3) for k, v in rep.step_seconds.items()})}; "
         f"{len(feats)} mask features x {spec.projection_dim} (norms {norms.min():.4f}.."
         f"{norms.max():.4f}), labels {lf.shape}, classes {classes}, AP {ap['all_ap']:.4f} "
         f"(random weights); phase 12 in {time.perf_counter() - t_phase:.1f} s")


@contextlib.contextmanager
def recording_stream_chunks(records: list):
    """Keep, for every ``StreamAccumulator.push_chunk`` attempt on any
    thread, its chunk dict and the launch counts just after it, or the
    exception it raised (a watchdog's abandoned attempt included)."""
    from maskclustering_tpu_torch.models.streaming import StreamAccumulator
    from maskclustering_tpu_torch.ops import cuda as kernels

    real = StreamAccumulator.push_chunk

    def push_chunk(acc, chunk):
        try:
            out = real(acc, chunk)
        except Exception as e:
            records.append({"error": e, "thread": threading.current_thread().name})
            raise
        records.append({"dict": out, "launches": dict(kernels.LAUNCHES.counts),
                        "thread": threading.current_thread().name})
        return out

    StreamAccumulator.push_chunk = push_chunk
    try:
        yield records
    finally:
        StreamAccumulator.push_chunk = real


@contextlib.contextmanager
def recording_stream_programs(calls: list):
    """Keep the inputs of every call to the three streaming programs, in
    call order, so that each can be timed again on them."""
    from maskclustering_tpu_torch.models import streaming

    names = ("_stream_merge", "_stream_recluster", "_rep_plane_update")
    real = {n: getattr(streaming, n) for n in names}

    def wrap(name):
        def program(*args, **kwargs):
            calls.append((name, args, kwargs))
            return real[name](*args, **kwargs)
        return program

    for n in names:
        setattr(streaming, n, wrap(n))
    try:
        yield calls
    finally:
        for n in names:
            setattr(streaming, n, real[n])


def wall_ms(fn, reps: int = 3) -> float:
    """Mean wall of ``fn()`` between device synchronisations (the
    re-cluster reads a flag on the host each sweep, so CUDA events would
    time the same wall)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def _stream_chunks(records):
    return [r["dict"] for r in records if "dict" in r]


def _check_stream_result(res, num_points: int, label: str) -> None:
    import numpy as np

    if not res.objects.point_ids_list:
        raise AssertionError(f"{label}: the stream produced no objects")
    for pids in res.objects.point_ids_list:
        if pids.size == 0 or int(pids.min()) < 0 or int(pids.max()) >= num_points:
            raise AssertionError(f"{label}: an object holds point ids outside the scene")
    if not np.all(np.isfinite(res.assignment)) or res.assignment.shape != res.table.frame.shape:
        raise AssertionError(f"{label}: assignment of shape {res.assignment.shape}")


def _long_scene_tensors():
    """Phase 13c's scan: phase 4's scene rendered with LONG_FRAMES frames,
    as SceneTensors, and the seconds the render took (in a CPU-reference
    process; numpy only)."""
    here = os.path.dirname(os.path.abspath(__file__))
    if here not in sys.path:
        sys.path.insert(0, here)
    from maskclustering_tpu_torch.utils.synthetic import (
        add_depth_noise,
        make_scene,
        to_scene_tensors,
    )

    t0 = time.perf_counter()
    scene = make_scene(num_boxes=8, num_frames=LONG_FRAMES, image_hw=(480, 640),
                       spacing=0.008, floor_spacing=0.016, seed=0)
    add_depth_noise(scene, sigma=0.002, seed=1000)
    return to_scene_tensors(scene), time.perf_counter() - t0


def _mesh_second_tensors():
    """Phase 14's second lane: a 480x640 scene of MESH_SECOND_FRAMES frames,
    as SceneTensors (in a CPU-reference process; numpy only)."""
    here = os.path.dirname(os.path.abspath(__file__))
    if here not in sys.path:
        sys.path.insert(0, here)
    from maskclustering_tpu_torch.utils.synthetic import (
        add_depth_noise,
        make_scene,
        to_scene_tensors,
    )

    second = make_scene(num_boxes=8, num_frames=MESH_SECOND_FRAMES, image_hw=(480, 640),
                        spacing=0.008, floor_spacing=0.016, seed=MESH_SECOND_SEED)
    add_depth_noise(second, sigma=0.002, seed=1000 + MESH_SECOND_SEED)
    return to_scene_tensors(second)


def _start_drill_cli(dev, batch) -> dict:
    """Start the batch driver's CLI under the JAX drill's four faults over
    phase 10's scans (a config file with phase 10's knobs), at the end of
    phase 10; phase 13 joins it after its in-process drills."""
    root = batch["root"]
    here = os.path.dirname(os.path.abspath(__file__))
    knobs = {k: v for k, v in dataclasses.asdict(batch["cfg"]).items()
             if k not in ("config_name", "data_root")}
    drill_cfg = os.path.join(root, "chip_smoke_drill.json")
    with open(drill_cfg, "w") as fh:
        json.dump(knobs, fh)
    names = [MID_SCAN] + list(BATCH_SCANS)
    spec = (f"load:{MID_SCAN}, stall:{BATCH_SCANS[0]}.device, flaky:{BATCH_SCANS[1]}:2, "
            f"fail:{BATCH_SCANS[2]}.post")
    report_path = os.path.join(root, "drill_report.json")
    env = dict(os.environ, MCT_FAULT_STALL_S="3600")
    err = os.path.join(root, "drill_cli.log")
    t0 = time.perf_counter()
    with open(err, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "maskclustering_tpu_torch.run", "--config", drill_cfg,
             "--data_root", root, "--seq_name_list", "+".join(names), "--steps", "cluster",
             "--no-resume", "--fault-plan", spec, "--watchdog-device", str(CLI_WATCHDOG_S),
             "--report", report_path, "--no-obs", "--device", str(dev)],
            cwd=here, env=env, stdout=subprocess.DEVNULL, stderr=log, text=True)
    return {"proc": proc, "t0": t0, "names": names, "spec": spec, "report": report_path,
            "err": err}


def streaming_phase(dev, tensors, dense, batch, cpu_refs, drill) -> dict:
    """Phase 13: the streaming entry point and the fault drills on the card
    (``drill``: the CLI drill started at the end of phase 10)."""
    import numpy as np
    import torch

    from maskclustering_tpu_torch.config import load_config
    from maskclustering_tpu_torch.models import run_scene, streaming
    from maskclustering_tpu_torch.models.streaming import stream_scene
    from maskclustering_tpu_torch.obs.digest import artifact_digest
    from maskclustering_tpu_torch.ops import cuda as kernels
    from maskclustering_tpu_torch.run import run_pipeline
    from maskclustering_tpu_torch.utils import faults
    from maskclustering_tpu_torch.utils.synthetic import make_scene, to_scene_tensors

    t_phase = time.perf_counter()
    cfg = dense["cfg"]

    # 13a: one chunk covering the scene is the batch path, digest dict and all
    kernels.LAUNCHES.reset()
    t0 = time.perf_counter()
    one = stream_scene(tensors, cfg.replace(streaming_chunk=tensors.num_frames),
                       seq_name="chip_smoke_dense", device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES.counts)
    _say(f"[stream] single chunk of {tensors.num_frames}: digest {json.dumps(one.digest)}, "
         f"wall {wall:.2f} s, launches {json.dumps(launches)}")
    if one.digest != dense["scene_digest"] or artifact_digest(one.objects) != dense["digest"]:
        raise AssertionError(f"the single-chunk stream's digest {one.digest} is not phase 8's "
                             f"{dense['scene_digest']}")
    if any(launches.get(n, 0) != 1 for n in ASSOCIATION_KERNELS):
        raise AssertionError("the single-chunk stream did not launch each association "
                             "kernel once")

    # 13b: four chunks of 8 frames, cuda against cpu (the CPU-reference
    # child's run from the end of phase 8), chunk by chunk
    cfg8 = cfg.replace(streaming_chunk=STREAM_CHUNK, config_name="chip_smoke_stream")
    programs = []
    records = []
    with recording_stream_chunks(records), recording_stream_programs(programs):
        kernels.LAUNCHES.reset()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        res = stream_scene(tensors, cfg8, seq_name="chip_smoke_stream", device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES.counts)
    cuda = {"res": res, "chunks": _stream_chunks(records), "records": records, "wall": wall,
            "launches": launches, "peak_mib": torch.cuda.max_memory_allocated(dev) / 2**20}
    t0 = time.perf_counter()
    cpu = cpu_refs["stream"].result(timeout=900)
    cpu_wait = time.perf_counter() - t0
    n_chunks = -(-tensors.num_frames // STREAM_CHUNK)
    prev = {}
    for c in cuda["records"]:
        delta = {k: v - prev.get(k, 0) for k, v in c["launches"].items()}
        prev = c["launches"]
        ch = c["dict"]
        _say(f"[stream] chunk {ch['chunk']}: {ch['frames']} frames, {ch['seconds']:.4f} s, "
             f"plane_bytes {ch['plane_bytes']}, masks {ch['masks']}, partial instances "
             f"{ch['partial_instances']}, digest {ch['digest']}, launches {json.dumps(delta)}")
    for key in ("digest", "partial_instances", "masks", "plane_bytes"):
        got = [c[key] for c in cuda["chunks"]]
        want = [c[key] for c in cpu["chunks"]]
        if got != want:
            raise AssertionError(f"chunk {key} cuda {got} != cpu {want}")
    rc = cuda["res"]
    if (rc.digest != cpu["digest"] or not np.array_equal(rc.assignment, cpu["assignment"])
            or artifact_digest(rc.objects) != cpu["artifact"]):
        raise AssertionError(f"the four-chunk stream differs: cuda {rc.digest} cpu "
                             f"{cpu['digest']}")
    _check_stream_result(rc, tensors.num_points, "four-chunk stream")
    for name in ASSOCIATION_KERNELS:
        if cuda["launches"].get(name, 0) != n_chunks:
            raise AssertionError(f"{name} launched {cuda['launches'].get(name, 0)} times in "
                                 f"{n_chunks} chunks, not once a chunk")
    if cuda["launches"].get("ball_query", 0):
        raise AssertionError("the stream launched the ball query")
    tm_c, tm_h = rc.timings, cpu["timings"]
    _say(f"[stream] {n_chunks} chunks of {STREAM_CHUNK}: cuda == cpu (every chunk digest and "
         f"partial count, objects {len(rc.objects.point_ids_list)}, assignment, digest "
         f"{json.dumps(rc.digest)}); wall cuda {cuda['wall']:.2f} s cpu {cpu['wall']:.2f} s "
         f"(the CPU-reference child, {cpu_wait:.1f} s of it waited for); "
         f"chunks cuda {tm_c['stream.chunks']:.3f} s cpu {tm_h['stream.chunks']:.3f} s; "
         f"finalize cuda {tm_c['stream.finalize']:.3f} s (host DBSCAN "
         f"{tm_c['stream.dbscan']:.3f} s, "
         f"{100 * tm_c['stream.dbscan'] / tm_c['stream.finalize']:.1f} %) cpu "
         f"{tm_h['stream.finalize']:.3f} s (DBSCAN {tm_h['stream.dbscan']:.3f} s); peak "
         f"device memory {cuda['peak_mib']:.1f} MiB; launches {json.dumps(cuda['launches'])}")
    per = {}
    for name, args, kwargs in programs:
        program = getattr(streaming, name)
        per.setdefault(name, []).append(wall_ms(lambda: program(*args, **kwargs)))
    _say("[stream] programs per chunk on cuda, ms (wall between synchronisations, mean of 3): "
         + json.dumps({k: [round(v, 3) for v in vs] for k, vs in per.items()}))

    # 13c: peak memory, batch against chunked, on a longer scan rendered
    # afresh (repeating the 32 frames would repeat their claims, and the
    # batch's post-process grows with the distinct views)
    t0 = time.perf_counter()
    lt, built_s = cpu_refs["long"].result(900)
    _say(f"[stream] {LONG_FRAMES}-frame scene built in {built_s:.1f} s in a CPU-reference "
         f"process from the end of phase 8 ({time.perf_counter() - t0:.1f} s of it waited "
         f"for; N={lt.num_points})")
    mem = {}
    for label, c in (("batch", cfg), ("chunked", cfg.replace(streaming_chunk=LONG_CHUNK))):
        records = []
        with recording_stream_chunks(records):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base_mib = torch.cuda.memory_allocated(dev) / 2**20
            t0 = time.perf_counter()
            run = run_scene if label == "batch" else stream_scene
            res = run(lt, c, seq_name="chip_smoke_long", device=dev)
            torch.cuda.synchronize()
            mem[label] = {"wall": time.perf_counter() - t0, "res": res,
                          "peak_mib": torch.cuda.max_memory_allocated(dev) / 2**20 - base_mib,
                          "plane_bytes": max((ch["plane_bytes"] for ch in
                                              _stream_chunks(records)), default=0)}
        _check_stream_result(res, lt.num_points, f"{LONG_FRAMES}-frame {label}")
    _say(f"[stream] {LONG_FRAMES} frames: batch peak {mem['batch']['peak_mib']:.1f} MiB wall "
         f"{mem['batch']['wall']:.2f} s ({len(mem['batch']['res'].objects.point_ids_list)} "
         f"objects); chunks of {LONG_CHUNK}: peak {mem['chunked']['peak_mib']:.1f} MiB wall "
         f"{mem['chunked']['wall']:.2f} s ({len(mem['chunked']['res'].objects.point_ids_list)} "
         f"objects, largest chunk planes {mem['chunked']['plane_bytes']} bytes; finalize "
         f"{mem['chunked']['res'].timings['stream.finalize']:.3f} s, host DBSCAN "
         f"{mem['chunked']['res'].timings['stream.dbscan']:.3f} s)")
    del lt, mem

    # 13d: fault drills. A mid-size scene streamed in three chunks
    mid = to_scene_tensors(make_scene(num_boxes=4, num_frames=12, image_hw=(240, 320), seed=1))
    mcfg = load_config("scannet", config_name="chip_smoke_mid_stream", distance_threshold=0.03,
                       few_points_threshold=10, streaming_chunk=4)
    ref = stream_scene(mid, mcfg, seq_name="mid_stream", device=dev)
    _check_stream_result(ref, mid.num_points, "mid-size stream")

    def same(res, label):
        if (artifact_digest(res.objects) != artifact_digest(ref.objects)
                or not np.array_equal(res.assignment, ref.assignment)
                or res.digest != ref.digest):
            raise AssertionError(f"the {label} drill's stream differs from the fault-free one")

    records = []
    faults.set_plan(faults.FaultPlan.from_spec("flaky:mid_stream.chunk:1"))
    try:
        with recording_stream_chunks(records):
            res = stream_scene(mid, mcfg, seq_name="mid_stream", device=dev)
    finally:
        faults.set_plan(None)
    same(res, "flaky")
    errors = [type(r["error"]).__name__ for r in records if "error" in r]
    if errors != ["InjectedFault"] or len(_stream_chunks(records)) != 3:
        raise AssertionError(f"flaky drill attempts: {errors}, "
                             f"{len(_stream_chunks(records))} ok")
    _say(f"[drill] flaky:mid_stream.chunk:1 healed: 1 failed chunk attempt ({errors[0]}), "
         f"3 chunks, artifacts == fault-free ({artifact_digest(ref.objects)})")

    records = []
    faults.set_plan(faults.FaultPlan.from_spec("stall:mid_stream.chunk:1",
                                               stall_s=DRILL_STALL_S))
    try:
        with recording_stream_chunks(records):
            t0 = time.perf_counter()
            res = stream_scene(mid, mcfg.replace(watchdog_device_s=DRILL_WATCHDOG_S),
                               seq_name="mid_stream", device=dev)
            wall = time.perf_counter() - t0
            deadline = time.monotonic() + 60.0
            while (not any("error" in r for r in records)
                   and time.monotonic() < deadline):
                time.sleep(0.1)
    finally:
        faults.set_plan(None)
    same(res, "stall")
    stale = [r for r in records if "error" in r]
    if (len(stale) != 1 or type(stale[0]["error"]).__name__ != "StaleChunkAttempt"
            or not stale[0]["thread"].startswith("watchdog-device")):
        raise AssertionError(f"stall drill: abandoned attempt ended {stale}")
    _say(f"[drill] stall:mid_stream.chunk:1 under a {DRILL_WATCHDOG_S:.0f} s watchdog: stream "
         f"{wall:.2f} s, artifacts == fault-free; the abandoned attempt woke after "
         f"{DRILL_STALL_S:.0f} s and raised {stale[0]['error']} on its thread "
         f"{stale[0]['thread']}")

    # the drill CLI started at the end of phase 10: its result
    root = batch["root"]
    names, spec, report_path = drill["names"], drill["spec"], drill["report"]
    proc = drill["proc"]
    proc.wait(timeout=900)
    wall = time.perf_counter() - drill["t0"]
    with open(drill["err"]) as fh:
        err_text = fh.read()
    if proc.returncode != 1:  # one scan fails by design
        raise AssertionError(f"drill CLI rc {proc.returncode}\n{err_text[-3000:]}")
    with open(report_path) as fh:
        rep = json.load(fh)
    by = {s["seq_name"]: s for s in rep["scenes"]}
    # the JAX drill's statuses (tests/test_faults.py:372-413) on the port's
    # two-rung ladder: the capacity fault heals on rung 2 at attempt 3
    got = {n: (by[n]["status"], by[n]["attempts"], by[n]["degradation_rung"]) for n in names}
    want = {MID_SCAN: ("failed", 3, 2), BATCH_SCANS[0]: ("ok", 2, 1),
            BATCH_SCANS[1]: ("ok", 3, 2), BATCH_SCANS[2]: ("ok", 3, 2)}
    for n in names:
        _say(f"[drill] {n}: {by[n]['status']}, attempts {by[n]['attempts']}, rung "
             f"{by[n]['degradation_rung']}, last error class {by[n]['error_class'] or '-'}, "
             f"{by[n]['seconds']:.2f} s")
    _say(f"[drill] CLI --fault-plan '{spec}': rc {proc.returncode}, {wall:.1f} s (started "
         f"after phase 10, beside phases 11-13), faults "
         f"{json.dumps(rep['faults'])}")
    if (got != want or by[MID_SCAN]["error_class"] != "retryable"
            or "InjectedFault" not in by[MID_SCAN]["error"]
            or rep["faults"]["device_stalls"] != 1
            or rep["faults"]["degradations"] != {"sequential-executor": 1,
                                                 "host-postprocess": 1}):
        raise AssertionError(f"drill statuses {got}, want {want}; faults {rep['faults']}")
    _artifacts_equal(root, os.path.join(root, "prediction"), "chip_smoke_drill", batch["pred"],
                     batch["cfg"].config_name, BATCH_SCANS)
    _say("[drill] every healed scan's npz and object dict == phase 10's fault-free run")

    # 13e: --streaming-chunk through the batch driver on phase 10's scans
    scfg = batch["cfg"].replace(config_name="chip_smoke_stream_batch",
                                streaming_chunk=STREAM_CHUNK)
    kernels.LAUNCHES.reset()
    rep = run_pipeline(scfg, BATCH_SCANS, steps=("cluster", "eval_ca"), resume=False,
                       journal=False, prediction_root=os.path.join(root, "prediction_stream"),
                       device=dev)
    launches = dict(kernels.LAUNCHES.counts)
    if not rep.ok or any(s.num_objects <= 0 for s in rep.scenes):
        raise AssertionError(f"the streaming batch run failed: {rep.step_errors} "
                             f"{[(s.seq_name, s.status, s.error[-300:]) for s in rep.scenes]}")
    if any(launches.get(n, 0) != n_chunks * len(BATCH_SCANS) for n in ASSOCIATION_KERNELS):
        raise AssertionError(f"streaming batch launches {launches}")
    ap, bap = rep.evaluation["eval_ca"], batch["ap"]
    if any(s.digest != rep.scenes[0].digest for s in rep.scenes):  # one scan, three names
        raise AssertionError(f"streamed scan digests differ: {[s.digest for s in rep.scenes]}")
    _say(f"[stream] --streaming-chunk {STREAM_CHUNK} over {len(BATCH_SCANS)} scans: cluster "
         f"{rep.step_seconds['cluster']:.3f} s "
         f"({rep.step_seconds['cluster'] / len(BATCH_SCANS):.3f} s/scan; batch "
         f"{batch['cluster_s'] / len(BATCH_SCANS):.3f}), AP {ap['all_ap']:.4f} "
         f"AP50 {ap['all_ap_50%']:.4f} AP25 {ap['all_ap_25%']:.4f} against the batch AP "
         f"{bap['all_ap']:.4f} AP50 {bap['all_ap_50%']:.4f}; objects "
         f"{[s.num_objects for s in rep.scenes]}; digest coord {rep.scenes[0].digest_coord}; "
         f"launches {json.dumps(launches)}")
    _say(f"[stream] phase 13 in {time.perf_counter() - t_phase:.1f} s")
    return {"launches": cuda["launches"]}


@contextlib.contextmanager
def recording_fused_outputs(outs: list):
    """Keep every ``FusedStepResult`` the batch path post-processes, once a
    batch, with the time its step's work ended on the card."""
    import torch

    from maskclustering_tpu_torch.parallel import batch as pb

    real = pb.fused_scene_objects

    def rec(out, index, *args, **kwargs):
        if index == 0:
            torch.cuda.synchronize()
            outs.append((out, time.perf_counter()))
        return real(out, index, *args, **kwargs)

    pb.fused_scene_objects = rec
    try:
        yield outs
    finally:
        pb.fused_scene_objects = real


def fused_batch(dev, cfg, mesh, lanes, names):
    """``cluster_scene_batch`` over ``lanes`` on ``mesh``, the launch counts
    set to 0 just before and read just after. Returns (objects, the step's
    result, launches, (wall, step) seconds, peak device MiB); the step's
    seconds include the host stacking of the batch."""
    import torch

    from maskclustering_tpu_torch.ops import cuda as kernels
    from maskclustering_tpu_torch.parallel import cluster_scene_batch

    outs = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.LAUNCHES.reset()
    with recording_fused_outputs(outs):
        t0 = time.perf_counter()
        objs = cluster_scene_batch(cfg, mesh, lanes, k_max=63, seq_names=names)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES.counts)
    (out, t_step), = outs
    return (objs, out, launches, (wall, t_step - t0),
            torch.cuda.max_memory_allocated(dev) / 2**20)


def _run_module(here: str, module: str, args, timeout: int = 600):
    """``python -m module args`` from the checkout: (returncode, stdout, stderr)."""
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=here, capture_output=True,
                          text=True, timeout=timeout)
    return proc.returncode, proc.stdout, proc.stderr


def _run_modules(here: str, calls):
    """Several ``_run_module(here, module, args)`` at once, for CLIs that
    only read files and time nothing: their results, in order."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(calls)) as pool:
        futures = [pool.submit(_run_module, here, module, args) for module, args in calls]
        # each call is bounded by its subprocess timeout; this bounds the wait too
        return [f.result(timeout=900.0) for f in futures]


def _run_cli(here: str, args, timeout: int = 600):
    rc, _, err = _run_module(here, "maskclustering_tpu_torch.run", args, timeout)
    if rc != 0:
        raise AssertionError(f"CLI {args} rc {rc}\n{err[-3000:]}")


def mesh_phase(dev, card: str, tensors, dense, mid_digests, batch, cpu_refs) -> dict:
    """Phase 14: the fused multi-device path on the card."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from maskclustering_tpu_torch.config import load_config
    from maskclustering_tpu_torch.models import run_scene
    from maskclustering_tpu_torch.obs.digest import artifact_digest
    from maskclustering_tpu_torch.ops import cuda as kernels
    from maskclustering_tpu_torch.parallel import cluster_scene_batch, make_mesh
    from maskclustering_tpu_torch.run import evaluate_step, run_pipeline
    from maskclustering_tpu_torch.utils.synthetic import make_scene, to_scene_tensors

    t_phase = time.perf_counter()
    cfg = dense["cfg"]
    root, ov_cfg, ov_pred, here = batch["root"], batch["cfg"], batch["pred"], os.path.dirname(
        os.path.abspath(__file__))
    knobs = {k: v for k, v in dataclasses.asdict(ov_cfg).items()
             if k not in ("config_name", "data_root")}

    def write_cfg(name: str, **kw) -> str:
        path = os.path.join(root, f"{name}.json")
        with open(path, "w") as fh:
            json.dump({**knobs, **kw}, fh)
        return path

    # 14d's two CLI runs (their processes on the card) start here, beside
    # 14a-14d's in-process runs: each checks its artifacts, none of their
    # seconds feeds the kernels line, and the launches counted are this
    # process's
    t_cli = time.perf_counter()
    report_path = os.path.join(root, "mesh_cli_report.json")
    wreport_path = os.path.join(root, "workers_report.json")
    names4 = list(BATCH_SCANS) + [MID_SCAN]
    cli_args = [
        ["--config", write_cfg("chip_smoke_mesh_cli", mesh_shape=[1, 1]), "--point-shards", "1",
         "--data_root", root, "--seq_name_list", "+".join(BATCH_SCANS), "--steps",
         "cluster,eval_ca", "--no-resume", "--report", report_path, "--no-obs"],
        ["--config", write_cfg("chip_smoke_workers"), "--workers", str(MESH_WORKERS),
         "--data_root", root, "--seq_name_list", "+".join(names4), "--steps", "cluster",
         "--no-resume", "--report", wreport_path, "--no-obs"]]
    cli_pool = ThreadPoolExecutor(len(cli_args))
    clis = [cli_pool.submit(_run_cli, here, args) for args in cli_args]
    # the second lane, rendered in a CPU-reference process from the end of
    # phase 8
    lanes = [tensors, cpu_refs["second"].result(timeout=900)]
    names = ["chip_smoke_mesh_a", "chip_smoke_mesh_b"]
    ref_b = run_scene(lanes[1], cfg, k_max=63, seq_name=names[1], device=dev)
    refs = [dense["digest"], artifact_digest(ref_b.objects)]

    # 14a: one lane a scene on the card, mesh (1, 1)
    one = make_mesh((1, 1), devices=[dev])
    solo, _, _, (solo_wall, solo_step), solo_peak = fused_batch(dev, cfg, one, lanes[:1],
                                                                names[:1])
    objs, out, launches, (wall, step), peak = fused_batch(dev, cfg, one, lanes, names)
    digests = [artifact_digest(o) for o in objs]
    f_pad, n_pad = int(out.node_visible[0].shape[1]), int(out.first_id[0][0].shape[1])
    _say(f"[mesh] (1, 1) over two 480x640 lanes (N={[t.num_points for t in lanes]}, "
         f"F={[t.num_frames for t in lanes]}; F_pad={f_pad} N_pad={n_pad} "
         f"M_pad={int(out.assignment[0].shape[0])} dense slots against run_scene's compacted "
         f"{dense['m_pad']}): objects {[len(o.point_ids_list) for o in objs]}, digests {digests}, "
         f"run_scene {refs}; launches {json.dumps(launches)}")
    _say(f"[mesh] {card}: fused batch {wall:.3f} s = {wall / 2:.3f} s a scene, of which the "
         f"step {step:.3f} s and the two post-processes {wall - step:.3f} s (one lane alone "
         f"{solo_wall:.3f} s, step {solo_step:.3f} s) against phase 8's run_scene "
         f"{dense['wall']:.3f} s; peak device memory one lane {solo_peak:.1f} MiB, two lanes "
         f"{peak:.1f} MiB")
    if digests != refs or artifact_digest(solo[0]) != refs[0]:
        raise AssertionError(f"mesh lanes {digests} (alone {artifact_digest(solo[0])}) != "
                             f"run_scene {refs}")
    for name in ASSOCIATION_KERNELS:
        if launches.get(name, 0) != len(lanes):
            raise AssertionError(f"{name} launched {launches.get(name, 0)} times for "
                                 f"{len(lanes)} lanes, not once a lane")
    if launches.get("ball_query", 0) or not all(o.point_ids_list for o in objs):
        raise AssertionError(f"mesh batch launches {launches}, objects "
                             f"{[len(o.point_ids_list) for o in objs]}")

    # 14b: shards on one card: meshes that repeat it
    for shape in ONE_CARD_MESHES:
        mesh = make_mesh(shape, devices=[dev] * int(np.prod(shape)))
        got, res, counts, (sec, step_sec), mib = fused_batch(dev, cfg, mesh, lanes, names)
        f_axis, p_axis = shape[1], (shape[2] if len(shape) > 2 else 1)
        per_row = len(lanes) // shape[0]
        grid = mesh.devices.reshape(shape[0], f_axis, p_axis)
        got_digests = [artifact_digest(o) for o in got]
        bad = [n for n in ASSOCIATION_KERNELS
               if counts.get(n, 0) != len(lanes) * f_axis * p_axis]
        for lane in range(len(lanes)):
            for p, shard in enumerate(res.first_id[lane]):
                if (tuple(shard.shape) != (f_pad, n_pad // p_axis)
                        or shard.device != grid[lane // per_row, 0, p]):
                    raise AssertionError(f"mesh {shape}: lane {lane} shard {p} is "
                                         f"{tuple(shard.shape)} on {shard.device}")
        _say(f"[mesh] {shape} on {int(np.prod(shape))} x {dev}: digests {got_digests}, "
             f"{sec:.3f} s (step {step_sec:.3f} s), peak {mib:.1f} MiB, launches "
             f"{json.dumps(counts)}; each first_id shard ({f_pad}, {n_pad // p_axis})")
        if got_digests != digests or bad:
            raise AssertionError(f"mesh {shape}: digests {got_digests} != {digests} or "
                                 f"launches {counts} not one a lane x frame shard x point shard")

    # 14c: card against cpu, a batch of one
    mid = to_scene_tensors(make_scene(num_boxes=4, num_frames=12, image_hw=(240, 320), seed=1))
    mid_cfg = load_config("scannet", config_name="chip_smoke_mid_dense", distance_threshold=0.03,
                          few_points_threshold=10)
    mids = []
    for d in (dev, torch.device("cpu")):
        t0 = time.perf_counter()
        (o,) = cluster_scene_batch(mid_cfg, make_mesh((1, 1), devices=[d]), [mid],
                                   seq_names=["mid"])
        mids.append((artifact_digest(o), time.perf_counter() - t0))
    _say(f"[mesh] mid-size batch of one: {dev} {mids[0][0]} ({mids[0][1]:.2f} s), cpu "
         f"{mids[1][0]} ({mids[1][1]:.2f} s), phase 9's run_scene {mid_digests[0]['artifact']}")
    if not mids[0][0] == mids[1][0] == mid_digests[0]["artifact"]:
        raise AssertionError("the mid-size mesh batch differs between cuda, cpu and run_scene")

    # 14d: the batch driver on phase 10's scans
    def check_run(label: str, pred: str, cfg_name: str, scenes, seconds: float,
                  coord: str) -> None:
        """The run's full-size scans: ok at ``coord``, phase 10's artifacts
        and AP; ``seconds`` is its cluster step."""
        scenes = [s for s in scenes if s["seq_name"] in BATCH_SCANS]
        if len(scenes) != len(BATCH_SCANS) or any(
                (s["status"], s["digest_coord"]) != ("ok", coord) for s in scenes):
            raise AssertionError(f"{label}: {[(s['seq_name'], s['status'], s['digest_coord'])
                                              for s in scenes]}")
        _artifacts_equal(root, ov_pred, ov_cfg.config_name, pred, cfg_name, BATCH_SCANS)
        ap = evaluate_step(ov_cfg.replace(config_name=cfg_name), no_class=True,
                           seq_names=BATCH_SCANS, prediction_root=pred, device=dev)
        if not _ap_equal(ap, batch["ap"]):
            raise AssertionError(f"{label}: AP {ap['all_ap']} != phase 10's")
        _say(f"[mesh] {label}: npz and object dicts == phase 10's, AP {ap['all_ap']:.4f} AP50 "
             f"{ap['all_ap_50%']:.4f}; cluster {seconds:.3f} s; digest coord {coord}")

    mcfg = ov_cfg.replace(config_name="chip_smoke_mesh_devices", mesh_shape=(2, 1),
                          point_shards=2)
    pred = os.path.join(root, "prediction_mesh_devices")
    kernels.LAUNCHES.reset()
    rep = run_pipeline(mcfg, BATCH_SCANS, steps=("cluster",), resume=False, journal=False,
                       prediction_root=pred, device=dev, mesh_devices=[dev] * 4)
    counts = dict(kernels.LAUNCHES.counts)
    for f in clis:
        f.result(timeout=900.0)
    cli_pool.shutdown()
    both = time.perf_counter() - t_cli
    lanes_run = 2 * -(-len(BATCH_SCANS) // 2)  # the short last batch has a pad lane
    if any(counts.get(n, 0) != lanes_run * 2 for n in ASSOCIATION_KERNELS):
        raise AssertionError(f"mesh_devices run launches {counts}, want {lanes_run * 2} each")
    check_run(f"run_pipeline mesh (2, 1) x point 2 over [{dev}] * 4, launches "
              f"{json.dumps(counts)}", pred, mcfg.config_name,
              [dataclasses.asdict(s) for s in rep.scenes], rep.step_seconds["cluster"],
              "fused|bf16|2x1|r0|c0")
    with open(report_path) as fh:
        crep = json.load(fh)
    check_run(f"CLI mesh_shape [1, 1] (started at the head of the phase beside the "
              f"in-process runs, {both:.1f} s to the last of the two CLIs)",
              os.path.join(root, "prediction"), "chip_smoke_mesh_cli", crep["scenes"],
              crep["step_seconds"]["cluster"], "fused|bf16|1x1|r0|c0")

    # worker processes over the four scans; the mid-size scan's reference
    # is an in-process run of the same config
    with open(wreport_path) as fh:
        wrep = json.load(fh)
    bucket = wrep["scenes"][0]["digest_coord"].split("|")[0]
    if [s["status"] for s in wrep["scenes"]] != ["ok"] * len(names4):
        raise AssertionError(f"workers run statuses {[s['status'] for s in wrep['scenes']]}")
    check_run(f"CLI --workers {MESH_WORKERS} over {len(names4)} scans (beside the other "
              f"runs)", os.path.join(root, "prediction"), "chip_smoke_workers", wrep["scenes"],
              wrep["step_seconds"]["cluster"], f"{bucket}|bf16|single|r0|c0")
    inproc = os.path.join(root, "prediction_mid_inproc")
    run_pipeline(ov_cfg.replace(config_name="chip_smoke_mid_inproc"), [MID_SCAN],
                 steps=("cluster",), resume=False, journal=False, prediction_root=inproc,
                 device=dev)
    _artifacts_equal(root, inproc, "chip_smoke_mid_inproc", os.path.join(root, "prediction"),
                     "chip_smoke_workers", [MID_SCAN])
    _say(f"[mesh] {card}: --workers {MESH_WORKERS} {wrep['step_seconds']['cluster']:.3f} s over "
         f"{len(names4)} scans = {wrep['step_seconds']['cluster'] / len(names4):.3f} s a scan "
         f"(sharing the card with the other two runs) against phase 10's "
         f"{batch['cluster_s'] / len(BATCH_SCANS):.3f}; {MID_SCAN} == its in-process run")
    _say(f"[mesh] phase 14 in {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches}


def _short_socket() -> str:
    """An AF_UNIX path well inside its 107 bytes: a fresh directory in the
    temporary directory, or in /tmp when that one's path is too long."""
    import tempfile

    base = tempfile.gettempdir()
    return os.path.join(tempfile.mkdtemp(prefix="mct", dir=base if len(base) <= 64 else "/tmp"),
                        "s.sock")


def _served_artifact_digest(root: str, seq: str, cfg_name: str, num_points: int) -> str:
    """``artifact_digest`` of the objects a daemon exported for ``seq``."""
    import types

    import numpy as np

    from maskclustering_tpu_torch.obs.digest import artifact_digest

    od = np.load(os.path.join(root, "scannet", "processed", seq, "output", "object", cfg_name,
                              "object_dict.npy"), allow_pickle=True).item()
    keys = sorted(od)
    return artifact_digest(types.SimpleNamespace(
        point_ids_list=[od[k]["point_ids"] for k in keys],
        mask_list=[od[k]["mask_list"] for k in keys], num_points=num_points))


def _served(client, scene: str, **kw):
    """One scene request: (ack, status events, terminal) with the protocol's
    order checked: the ack first, then status events, then one result."""
    ack = client.request_scene(scene, **kw)
    if ack.get("kind") != "ack":
        return ack, [], ack
    statuses = []
    term = client.wait_result(collect=statuses)
    return ack, statuses, term


def _quantile(vals, q: float) -> float:
    """The nearest-rank rule of the serve worker's latency digest."""
    from maskclustering_tpu_torch.obs.metrics import percentile

    return percentile(sorted(vals), q)


def serve_phase(dev, card: str, dense, batch) -> dict:
    """Phase 15: the scene-serving daemon on the card."""
    import shutil

    from maskclustering_tpu_torch import obs
    from maskclustering_tpu_torch.models.streaming import stream_scene
    from maskclustering_tpu_torch.obs.digest import artifact_digest
    from maskclustering_tpu_torch.obs.events import read_events
    from maskclustering_tpu_torch.ops import cuda as kernels
    from maskclustering_tpu_torch.serve import ServeClient, ServeDaemon
    from maskclustering_tpu_torch.serve import wal as serve_wal
    from maskclustering_tpu_torch.datasets import get_dataset
    from maskclustering_tpu_torch.utils import faults

    t_phase = time.perf_counter()
    root = batch["root"]
    cfg = batch["cfg"].replace(config_name="chip_smoke_serve")
    pred = os.path.join(root, "prediction_serve")
    jdir = os.path.join(root, "serve_journals")
    events_path = os.path.join(root, "serve_events.jsonl")
    shutil.rmtree(jdir, ignore_errors=True)
    want = batch["scans"]  # phase 10's {scan: (digest dict, objects)}
    first = BATCH_SCANS[0]
    num_points = {}

    def counts():
        return dict(kernels.LAUNCHES.counts)

    def delta(before, after):
        return {n: after.get(n, 0) - before.get(n, 0) for n in ASSOCIATION_KERNELS}

    def check_ok(term, scene, label):
        if term.get("kind") != "result" or term.get("status") != "ok":
            raise AssertionError(f"{label}: {scene} answered {term}")
        dg, n_obj = want[scene]
        if term["digest"]["artifact"] != dg["artifact"] or term["num_objects"] != n_obj:
            raise AssertionError(f"{label}: {scene} digest {term['digest']} objects "
                                 f"{term['num_objects']}, phase 10's {dg} {n_obj}")

    kernels.LAUNCHES.reset()
    obs.configure(events_path, truncate=True, meta={"tool": "chip_smoke", "device": str(dev)})
    sock = _short_socket()
    # (a) start: one scan warm
    daemon = ServeDaemon(cfg, socket_path=sock, capacity=SERVE_CAPACITY, journal_dir=jdir,
                         prediction_root=pred, warm_scenes=(first,), device=dev,
                         telemetry_window_s=1.0)
    t0 = time.perf_counter()
    daemon.start()
    start_s = time.perf_counter() - t0
    _say(f"[serve] {card}: daemon on {sock} (capacity {SERVE_CAPACITY}, device {dev}), "
         f"warm-up of {first} {daemon.stats()['warmup_s']:.2f} s, start {start_s:.2f} s")

    # (b) sequential requests: each scan, then the first again
    rows = []
    with ServeClient(sock, timeout_s=600.0) as c:
        for scene in list(BATCH_SCANS) + [first]:
            before = counts()
            t0 = time.perf_counter()
            ack, statuses, term = _served(c, scene, tag="seq")
            wall = time.perf_counter() - t0
            d = delta(before, counts())
            if ack.get("kind") != "ack" or [s.get("state") for s in statuses] != ["running"]:
                raise AssertionError(f"{scene}: events {ack} {statuses}")
            check_ok(term, scene, "sequential")
            if any(v != 1 for v in d.values()):
                raise AssertionError(f"{scene}: association launches {d}, not one each")
            rows.append((scene, term, wall))
        # a synthetic scene at a bucket no earlier phase dispatched: cold,
        # then warm
        cold = []
        for _ in range(2):
            before = counts()
            ack, statuses, term = _served(c, "chip_smoke_serve_cold", synthetic=SERVE_COLD_SPEC)
            if term.get("status") != "ok" or delta(before, counts()) != {
                    n: 1 for n in ASSOCIATION_KERNELS}:
                raise AssertionError(f"cold synthetic request: {term}")
            cold.append((term, statuses[0].get("warm")))
    for scene, term, wall in rows:
        _say(f"[serve] {scene}: ack, running, ok in {term['seconds']:.3f} s (scene "
             f"{term['scene_seconds']:.3f} s, client wall {wall:.3f} s), buckets_new "
             f"{term['buckets_new']}, digest {term['digest']['artifact']} == phase 10's, "
             f"{term['num_objects']} objects, one launch of each association kernel")
    (c0, w0), (c1, w1) = cold
    if c0["buckets_new"] < 1 or c1["buckets_new"] != 0 or w1 is not True \
            or c0["digest"] != c1["digest"]:
        raise AssertionError(f"cold/warm synthetic: {c0} {c1}")
    _say(f"[serve] synthetic {SERVE_COLD_SPEC} bucket {c0['bucket']}: cold {c0['seconds']:.3f} s "
         f"(scene {c0['scene_seconds']:.3f} s, buckets_new {c0['buckets_new']}, the write of "
         f"the scan and the classification included), warm {c1['seconds']:.3f} s (scene "
         f"{c1['scene_seconds']:.3f} s, buckets_new 0), digest {c1['digest']['artifact']}")
    warm_scene = [r[1]["scene_seconds"] for r in rows[1:]]
    _say(f"[serve] warm scan requests {min(warm_scene):.3f}-{max(warm_scene):.3f} s a scene "
         f"against phase 8's run_scene wall {dense['wall']:.3f} s (obs off) and phase 10's "
         f"{batch['cluster_s'] / len(BATCH_SCANS):.3f} s a scan")

    # (c) concurrency: client threads at capacity 2
    results, errors = [], []

    def client_thread(i):
        try:
            with ServeClient(sock, timeout_s=600.0) as cc:
                for j in range(SERVE_PER_THREAD):
                    scene = BATCH_SCANS[(i + j) % len(BATCH_SCANS)]
                    t0 = time.perf_counter()
                    term, _, _ = cc.run_scene(scene, tag=f"c{i}.{j}")
                    results.append((scene, term, time.perf_counter() - t0))
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(repr(e))

    threads = [threading.Thread(target=client_thread, args=(i,), name=f"serve-client-{i}")
               for i in range(SERVE_THREADS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(600.0)
    wall = time.perf_counter() - t0
    if errors or any(th.is_alive() for th in threads):
        raise AssertionError(f"concurrent clients: {errors}")
    rejected = [t for _, t, _ in results if t.get("kind") == "reject"]
    if any(t.get("reason") != "queue_full" for t in rejected):
        raise AssertionError(f"concurrent rejects: {rejected}")
    served = [(s, t, w) for s, t, w in results if t.get("kind") != "reject"]
    for scene, term, _ in served:
        check_ok(term, scene, "concurrent")
    # the result's seconds run from dispatch; the client's wall adds the queue
    secs = [t["seconds"] for _, t, _ in served]
    walls = [w for _, _, w in served]
    stats = daemon.stats()
    _say(f"[serve] {SERVE_THREADS} client threads x {SERVE_PER_THREAD} at capacity "
         f"{SERVE_CAPACITY}: {len(served)} ok with phase 10's digests, {len(rejected)} typed "
         f"queue_full; over {len(secs)} requests (a smoke reading: p95 of so few is their "
         f"largest) seconds p50 {_quantile(secs, 50):.3f} p95 {_quantile(secs, 95):.3f}, "
         f"client wall (queue included) p50 {_quantile(walls, 50):.3f} p95 "
         f"{_quantile(walls, 95):.3f}; {len(served) / wall:.3f} requests a second over "
         f"{wall:.2f} s with one worker, queue high-water {stats['queue']['high_water']}")

    # (e) a served stream: four chunks of 8 over one scan, then stream_end
    scene = BATCH_SCANS[1]
    t0 = time.perf_counter()
    with ServeClient(sock, timeout_s=600.0) as c:
        chunks = []
        before = counts()
        for i in range(4):
            term, statuses = c.stream_chunk(scene, chunk=STREAM_CHUNK if i == 0 else 0)
            if term.get("status") != "ok":
                raise AssertionError(f"stream chunk {i}: {term}")
            chunks.append((term, [s.get("state") for s in statuses]))
        end, _ = c.stream_end(scene)
        d = delta(before, counts())
    wall = time.perf_counter() - t0
    if end.get("status") != "ok" or not chunks[-1][0]["done"] or end["chunks"] != 4:
        raise AssertionError(f"stream end: {end}")
    if any(v != 4 for v in d.values()):
        raise AssertionError(f"served stream launches {d}, not one a chunk")
    ds = get_dataset("scannet", scene, data_root=root)
    tensors = ds.load_scene_tensors(cfg.step)
    num_points[scene] = tensors.num_points
    ref_cfg = cfg.replace(config_name="chip_smoke_serve_stream_ref", streaming_chunk=STREAM_CHUNK)
    ref_pred = os.path.join(root, "prediction_serve_stream_ref")
    # the in-process reference launches outside the daemon: kept out of the
    # phase's count of served launches
    before_ref = counts()
    ref = stream_scene(tensors, ref_cfg, seq_name=scene, export=True,
                       object_dict_dir=ds.object_dict_dir, prediction_root=ref_pred, device=dev)
    outside = delta(before_ref, counts())
    served_dg = _served_artifact_digest(root, scene, cfg.config_name, tensors.num_points)
    _artifacts_equal(root, pred, cfg.config_name, ref_pred, ref_cfg.config_name, [scene])
    if served_dg != artifact_digest(ref.objects):
        raise AssertionError(f"served stream digest {served_dg} != in-process "
                             f"{artifact_digest(ref.objects)}")
    _say(f"[serve] stream over {scene}: chunks "
         + ", ".join(f"{t['chunk']} ({t['seconds']:.3f} s, {t['partial_instances']} partial, "
                     f"{'/'.join(st)})" for t, st in chunks)
         + f"; stream_end {end['seconds']:.3f} s, {end['num_objects']} objects; end to end "
         f"{wall:.2f} s; artifacts and digest {served_dg} == in-process stream_scene; "
         f"launches {json.dumps(d)}")

    # (g) the status op with the SLO detail
    with ServeClient(sock, timeout_s=60.0) as c:
        st = c.slo()
    tele = st.get("telemetry") or {}
    if not tele.get("windows") or st.get("slo", {}).get("spec") != "serve-default" \
            or st["counts"]["ok"] < len(rows) + 2 + len(served):
        raise AssertionError(f"status detail=slo: {json.dumps(st)[:2000]}")
    _say(f"[serve] status slo: counts {json.dumps(st['counts'])}, latency "
         f"{json.dumps(st['latency'])}, {len(tele['windows'])} telemetry windows, slo ok "
         f"{st['slo']['ok']} ({', '.join(o['name'] + ' ' + o['state'] for o in st['slo']['objectives'])})")

    # 24(a): the port's load generator against this warm daemon
    load = load_gen_serve(card, sock)

    # (f) drain: one request held in flight, two queued, then stop
    plan = faults.FaultPlan.from_spec(f"stall:{first}.device:1", stall_s=SERVE_STALL_S)
    faults.set_plan(plan)
    out = {}

    def drain_client(i, scene, idem):
        with ServeClient(sock, timeout_s=600.0) as cc:
            out[i] = cc.run_scene(scene, idem=idem)[0]

    drains = [threading.Thread(target=drain_client, args=(0, first, "chip-smoke-drain-0"))]
    drains[0].start()
    t_end = time.monotonic() + 120
    while plan.entries[0].remaining != 0 and time.monotonic() < t_end:
        time.sleep(0.01)
    for i in (1, 2):
        drains.append(threading.Thread(target=drain_client,
                                       args=(i, BATCH_SCANS[i], f"chip-smoke-drain-{i}")))
        drains[-1].start()
    while daemon.queue.depth() < 2 and time.monotonic() < t_end:
        time.sleep(0.01)
    t0 = time.perf_counter()
    daemon.request_stop()
    daemon.shutdown(timeout_s=120.0)
    drain_s = time.perf_counter() - t0
    for th in drains:
        th.join(120.0)
    faults.set_plan(None)
    if set(out) != {0, 1, 2}:
        raise AssertionError(f"drain answers {out}")
    check_ok(out[0], first, "drain in flight")
    if [out[i].get("reason") for i in (1, 2)] != ["draining", "draining"]:
        raise AssertionError(f"drain queued answers {out[1]} {out[2]}")
    daemon.emit_serve_counters()
    obs.flush_metrics()
    obs.disable()
    spans = [e for e in read_events(events_path, kinds=["span"]) if e["name"] == "serve.request"]
    metric_rows = list(read_events(events_path, kinds=["metrics"]))
    serve_counters = sorted(k for k in metric_rows[-1]["metrics"]["counters"]
                            if k.startswith("serve."))
    if not spans or "serve.requests_ok" not in serve_counters:
        raise AssertionError(f"events file: {len(spans)} serve.request spans, counters "
                             f"{serve_counters}")
    sock2 = _short_socket()
    second = ServeDaemon(cfg, socket_path=sock2, capacity=SERVE_CAPACITY, journal_dir=jdir,
                         prediction_root=pred, device=dev)
    second.start()
    try:
        with ServeClient(sock2, timeout_s=600.0) as c:
            again, _, _ = c.run_scene(first, idem="chip-smoke-drain-0")
        durable = second.stats()["durable"]
    finally:
        second.request_stop()
        second.shutdown()
    wal_state = serve_wal.read_wal(os.path.join(jdir, serve_wal.WAL_FILENAME))
    if not again.get("deduped") or again.get("id") != out[0]["id"] \
            or durable["wal_deduped"] != 1 or wal_state.pending:
        raise AssertionError(f"WAL recovery: {again} {durable}")
    _say(f"[serve] drain: in flight {out[0]['id']} ok ({out[0]['seconds']:.3f} s, its "
         f"{SERVE_STALL_S:g} s stall included), {out[1]['id']} and {out[2]['id']} draining "
         f"rejects, shutdown {drain_s:.2f} s; a second daemon on the journal directory "
         f"recovered the WAL ({durable['wal_replayed']} replayed, {len(wal_state.answered)} "
         f"answered keys) and deduped {again['id']} ok; events: {len(spans)} serve.request "
         f"spans, counters {serve_counters}")

    # (d) packed batch: two same-bucket scans in one fused dispatch
    pcfg = cfg.replace(config_name="chip_smoke_serve_packed", serve_batch_max=SERVE_BATCH,
                       serve_batch_linger_s=2.0)
    sock3 = _short_socket()
    packed = ServeDaemon(pcfg, socket_path=sock3, capacity=4, prediction_root=pred,
                         warm_scenes=tuple(BATCH_SCANS[1:]), device=dev, wal=False)
    t0 = time.perf_counter()
    packed.start()
    warm_s = time.perf_counter() - t0
    pout = {}

    def packed_client(scene):
        with ServeClient(sock3, timeout_s=600.0) as cc:
            pout[scene] = cc.run_scene(scene)[0]

    try:
        before = counts()
        pts = [threading.Thread(target=packed_client, args=(s,)) for s in BATCH_SCANS[1:]]
        t0 = time.perf_counter()
        for th in pts:
            th.start()
        for th in pts:
            th.join(600.0)
        wall = time.perf_counter() - t0
        d = delta(before, counts())
        bstats = packed.worker.batch_stats()
    finally:
        packed.request_stop()
        packed.shutdown()
    for scene in BATCH_SCANS[1:]:
        check_ok(pout.get(scene, {}), scene, "packed")
        if pout[scene].get("batch") != SERVE_BATCH:
            raise AssertionError(f"packed {scene}: {pout[scene]}")
    if any(v != SERVE_BATCH for v in d.values()):
        raise AssertionError(f"packed launches {d}, not one a lane")
    per = [pout[s]["scene_seconds"] for s in BATCH_SCANS[1:]]
    _say(f"[serve] packed: warm-up {warm_s:.2f} s; {SERVE_BATCH} requests in one fused dispatch "
         f"(batch {SERVE_BATCH}, hist {bstats['hist']}), {per[0]:.3f} s a scene, client wall "
         f"{wall:.3f} s, digests == (b)'s, launches {json.dumps(d)}")
    launches = {n: v - outside.get(n, 0) - load["launches"].get(n, 0)
                for n, v in counts().items()}
    for s in (sock, sock2, sock3):
        shutil.rmtree(os.path.dirname(s), ignore_errors=True)
    _say(f"[serve] launches through the daemons over the phase {json.dumps(launches)} "
         f"(the in-process reference stream's {json.dumps(outside)} and phase 24(a)'s load "
         f"{json.dumps(load['launches'])} left out)")
    _say(f"[serve] phase 15 in {time.perf_counter() - t_phase:.1f} s, of it 24(a) "
         f"{load['seconds']:.1f} s")
    return {"launches": launches, "cold_digest": c0["digest"]["artifact"],
            "seq": [(scene, term["seconds"], wall) for scene, term, wall in rows],
            "load": load}


def _wait_for(pred, timeout_s: float, what: str) -> None:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out after {timeout_s:.0f} s waiting for {what}")


def obs_phase(dev, card: str, tensors, dense, batch, after_timing=None) -> dict:
    """Phase 16: the run report, the perf ledger, the request trace, live top
    and the canary sentinel on the card, and the stage spans they read;
    ``after_timing()`` is called once its timed runs of phase 8's scene are
    done."""
    import shutil
    import tempfile

    import torch

    from maskclustering_tpu_torch import obs
    from maskclustering_tpu_torch.config import load_config
    from maskclustering_tpu_torch.models import run_scene
    from maskclustering_tpu_torch.models.streaming import stream_scene
    from maskclustering_tpu_torch.obs import canary, flight, ledger, metrics
    from maskclustering_tpu_torch.obs.digest import artifact_digest
    from maskclustering_tpu_torch.obs.events import KIND_DRIFT, KIND_SPAN, read_events
    from maskclustering_tpu_torch.ops import cuda as kernels
    from maskclustering_tpu_torch.run import run_pipeline
    from maskclustering_tpu_torch.serve import ServeClient, ServeDaemon
    from maskclustering_tpu_torch.utils.synthetic import make_scene, to_scene_tensors

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    guarded = {p: open(p, "rb").read() for p in (os.path.join(here, "PERF_LEDGER.jsonl"),
                                                 os.path.join(here, "canary_goldens.json"))
               if os.path.exists(p)}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    root, scan = batch["root"], BATCH_SCANS[0]
    led_path = os.path.join(tmp, "ledger.jsonl")

    # phase 8's scene again, obs off: the disarmed spans must not move it
    t0 = time.perf_counter()
    again = run_scene(tensors, dense["cfg"], k_max=63, seq_name="chip_smoke_dense", device=dev)
    torch.cuda.synchronize()
    wall8 = time.perf_counter() - t0
    if artifact_digest(again.objects) != dense["digest"]:
        raise AssertionError("phase 8's scene gave another digest with obs off")
    # and armed: every span fences, which is the cost of the fences
    obs.configure(os.path.join(tmp, "scene_events.jsonl"), truncate=True)
    try:
        t0 = time.perf_counter()
        armed8 = run_scene(tensors, dense["cfg"], k_max=63, seq_name="chip_smoke_dense",
                           device=dev)
        torch.cuda.synchronize()
        wall8_armed = time.perf_counter() - t0
    finally:
        obs.disable()
    if armed8.digest != again.digest or armed8.timings["pulls"] != again.timings["pulls"]:
        raise AssertionError("phase 8's scene armed differs from unarmed")
    _say(f"[obs] {card}: phase 8's scene with obs off {wall8:.3f} s (phase 8: "
         f"{dense['wall']:.3f} s), armed {wall8_armed:.3f} s; stage walls off / armed "
         + json.dumps({k: [round(again.timings[k], 4), round(armed8.timings[k], 4)]
                       for k in ("associate", "graph", "cluster", "postprocess")})
         + f"; pulls {again.timings['pulls']}")
    if after_timing is not None:
        after_timing()

    # (a) a reported scan through the CLI: events, obs digest, one ledger row
    cfg_path = os.path.join(tmp, "chip_smoke_obs.json")
    with open(cfg_path, "w") as fh:
        json.dump({k: v for k, v in dataclasses.asdict(batch["cfg"]).items()
                   if k not in ("config_name", "data_root")}, fh)
    report_path = os.path.join(tmp, "R.json")
    t0 = time.perf_counter()
    rc, _, err = _run_module(here, "maskclustering_tpu_torch.run", [
        "--config", cfg_path, "--data_root", root, "--seq_name_list", scan, "--steps",
        "cluster,eval_ca", "--no-resume", "--no-journal", "--report", report_path,
        "--ledger", led_path, "--device", str(dev)])
    cli_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"reported run rc {rc}\n{err[-3000:]}")
    events_path = os.path.join(tmp, "R_events.jsonl")
    with open(report_path) as fh:
        rep = json.load(fh)
    (st,) = rep["scenes"]
    stages = rep["obs"]["stages"]
    counters = rep["obs"]["counters"]
    if not os.path.exists(events_path) or any(
            stages.get(s, {}).get("count") != 1
            for s in ("associate", "graph", "cluster", "postprocess")):
        raise AssertionError(f"report obs stages {sorted(stages)}")
    if counters.get("pipeline.host_sync") != st["timings"]["pulls"]:
        raise AssertionError(f"pipeline.host_sync {counters.get('pipeline.host_sync')} != "
                             f"pulls {st['timings']['pulls']}")
    if st["digest"] != batch["scans"][scan][0]:
        raise AssertionError(f"reported scan digest {st['digest']} != phase 10's")
    rows = ledger.read_ledger(led_path)
    if len(rows) != 1 or rows[0]["tool"] != "run":
        raise AssertionError(f"ledger rows {rows}")
    _say(f"[obs] reported scan {scan} (CLI, {cli_s:.1f} s with the process): {st['seconds']:.3f} "
         f"s armed against phase 10's {batch['scene_seconds'][scan]:.3f} s unarmed; stages "
         + json.dumps({k: v["p50_s"] for k, v in stages.items()
                       if k in ("associate", "graph", "cluster", "postprocess", "export")})
         + f"; device p50 " + json.dumps({k: v["device_p50_s"] for k, v in stages.items()
                                          if k in ("associate", "graph", "cluster",
                                                   "postprocess")})
         + f"; pipeline.host_sync {counters['pipeline.host_sync']} == pulls; digest "
         f"{st['digest']['artifact']} == phase 10's; one ledger row ({rows[0]['value']} s/scene)")

    # (b) the report CLI: table, diff, history, the regress gate both ways
    events2 = os.path.join(tmp, "R2_events.jsonl")
    rep2 = run_pipeline(batch["cfg"].replace(config_name="chip_smoke_obs"), [scan],
                        steps=("cluster", "eval_ca"), resume=False, journal=False,
                        report_path=os.path.join(tmp, "R2.json"), obs_events=events2,
                        ledger_path=led_path, prediction_root=os.path.join(tmp, "pred2"),
                        device=dev)
    if rep2.scenes[0].digest != st["digest"] or obs.enabled():
        raise AssertionError("the second armed run differs, or left obs armed")
    _say(f"[obs] the same scan armed in this process: {rep2.scenes[0].seconds:.3f} s")
    report_mod = "maskclustering_tpu_torch.obs.report"
    hist = ledger.read_ledger(led_path)
    if len(hist) != 2:
        raise AssertionError(f"the ledger holds {len(hist)} rows, not 2")
    # the gate reads the newest row. The first row, its headline raised to
    # the newest one's if lower (two runs of a scan differ by host noise),
    # passes; half the newest row's headline reads a 100 % slowdown
    bases = {}
    for label, value in (("pass", max(hist[0]["value"], hist[1]["value"])),
                         ("fail", hist[1]["value"] * 0.5)):
        bases[label] = os.path.join(tmp, f"baseline_{label}.json")
        with open(bases[label], "w") as fh:
            json.dump(dict(hist[0], value=value), fh)
    # the five CLI runs only read these files: all at once
    (rc, out, err), (rc_d, out_d, err_d), (rc_h, out_h, err_h), *regress = _run_modules(
        here, [(report_mod, [events_path]), (report_mod, [events_path, "--diff", events2]),
               (report_mod, ["--history", "--ledger", led_path])]
        + [(report_mod, ["--ledger", led_path, "--regress", bases[label]])
           for label in ("pass", "fail")])
    if rc != 0 or "postprocess" not in out or "dev.p50" not in out:
        raise AssertionError(f"report CLI rc {rc}\n{out[-2000:]}{err[-2000:]}")
    table = [ln for ln in out.splitlines()
             if ln.split()[:1] and ln.split()[0] in ("associate", "graph", "cluster",
                                                     "postprocess")]
    if rc_d != 0 or "A vs B" not in out_d or rc_h != 0 or "(2 rows)" not in out_h:
        raise AssertionError(f"diff rc {rc_d} / history rc {rc_h}\n{err_d[-1500:]}"
                             f"{err_h[-1500:]}")
    gates = dict(zip(("pass", "fail"), regress))
    if gates["pass"][0] != 0 or gates["fail"][0] == 0:
        raise AssertionError(f"regress gate rc pass {gates['pass'][0]} fail {gates['fail'][0]}"
                             f"\n{gates['pass'][1][-1500:]}{gates['fail'][1][-1500:]}")
    _say("[obs] report CLI: stage table\n" + "\n".join(table) + f"\n[obs] --diff rc 0, "
         f"--history rc 0 over {len(hist)} rows ({hist[0]['value']} / {hist[1]['value']} s/scene), "
         f"--regress rc {gates['pass'][0]} against the first row (headline "
         f"{max(hist[0]['value'], hist[1]['value'])}), rc {gates['fail'][0]} against half the "
         f"newest row's headline: " + [ln for ln in gates["fail"][1].splitlines()
                            if ln.startswith("headline")][0])

    # (c) the canary sentinel on the card against the committed goldens, and
    # (e) a traced request and top while it runs
    goldens_path = os.path.join(here, "canary_goldens.json")
    goldens = canary.load_goldens(goldens_path)
    if goldens is None:
        raise AssertionError("the committed canary goldens did not load")
    ccfg = canary.goldens_config().replace(
        config_name="chip_smoke_canary", dataset="scannet", step=1,
        data_root=os.path.join(tmp, "served"))
    serve_events = os.path.join(tmp, "serve_events.jsonl")
    jdir = os.path.join(tmp, "journals")
    metrics.registry().reset()
    obs.configure(serve_events, truncate=True, meta={"tool": "chip_smoke", "device": str(dev)})
    sock = _short_socket()
    daemon = ServeDaemon(ccfg, socket_path=sock, journal_dir=jdir,
                         warm_baseline=os.path.join(here, "compile_surface_baseline.json"),
                         canary_interval_s=1.0, canary_goldens=goldens_path,
                         telemetry_window_s=1.0, device=dev)
    t0 = time.perf_counter()
    daemon.start()
    start_s = time.perf_counter() - t0
    try:
        if daemon.sentinel is None:
            raise AssertionError("the sentinel did not arm")
        _wait_for(lambda: daemon.sentinel.stats()["rounds"] >= 2, 120.0, "two canary rounds")
        _wait_for(lambda: daemon.aggregator.snapshot()["windows"], 30.0, "a telemetry window")
        with ServeClient(sock, timeout_s=600.0) as c:
            sent = c.sentinel()
            slo = c.slo()["slo"]
            term, _, _ = c.run_scene("chip_smoke_traced", synthetic={
                "num_boxes": 4, "num_frames": 12, "image_hw": [240, 320], "seed": 1})
        s = sent["sentinel"]
        correctness = {o["name"]: o for o in slo["objectives"]}["correctness"]
        if ("rounds" not in s or s["rounds"] < 2 or s["drift_total"] != 0
                or s["coords"] != sorted(goldens["goldens"])
                or any(r["status"] != "ok" for r in s["last_results"])
                or correctness["state"] != "ok"):
            raise AssertionError(f"sentinel {s}, correctness {correctness}")
        if term.get("status") != "ok":
            raise AssertionError(f"traced request: {term}")
        # one round more, with the sentinel's own ticks stopped: its probes
        # and the kernel launches it took
        daemon.sentinel.stop()
        if not daemon.worker.wait_idle(60.0):
            raise AssertionError("the worker did not go idle")
        kernels.LAUNCHES.reset()
        probes = daemon.worker.run_canary()
        canary_launches = dict(kernels.LAUNCHES.counts)
        verdicts = [canary.compare_probe(p, goldens) for p in probes or []]
        if len(verdicts) != len(goldens["goldens"]) or any(
                v["status"] != "ok" for v in verdicts):
            raise AssertionError(f"canary probes {verdicts}")
        if any(canary_launches.get(n, 0) != len(probes) for n in ASSOCIATION_KERNELS):
            raise AssertionError(f"canary round launches {canary_launches}")
        _say(f"[canary] {card}: daemon start (warm-up of the goldens' scenes) {start_s:.2f} s; "
             f"{s['rounds']} rounds every {s['interval_s']:g} s, drift {s['drift_total']}; "
             f"correctness {correctness['state']} (observed {correctness['observed_long']}); "
             + "; ".join(f"{p['scene']} {p['coord']}: artifact {p['digest']['artifact']} plane "
                         f"{p['digest']['plane']} == goldens, {p['seconds']:.3f} s"
                         for p in probes)
             + f"; a round's launches {json.dumps(canary_launches)}")

        # (e) the traced request and top
        (rc_t, out_t, err_t), (rc_top, out_top, err_top) = _run_modules(here, [
            ("maskclustering_tpu_torch.obs.trace",
             [term["id"], "--events", serve_events, "--journal", jdir]),
            ("maskclustering_tpu_torch.obs.top", ["--socket", sock, "--once"])])
        lines = out_t.splitlines()

        def find(key, start):
            """The first line from ``start`` on that shows ``key`` (a stage
            child line by its exact name)."""
            for i in range(start, len(lines)):
                if key.startswith("· "):
                    if "· " in lines[i] and \
                            lines[i].split("· ", 1)[1].split(" (")[0].strip() == key[2:]:
                        return i
                elif key in lines[i]:
                    return i
            return -1

        pos = 0
        for key in ("queue wait", "execution", "· associate", "· graph", "· cluster",
                    "· postprocess", "outcome ok"):
            pos = find(key, pos)
            if pos < 0:
                break
        if rc_t != 0 or pos < 0:
            raise AssertionError(f"trace rc {rc_t}\n{out_t[-3000:]}{err_t[-1500:]}")
        if rc_top != 0 or "mct-serve top" not in out_top:
            raise AssertionError(f"top rc {rc_top}\n{out_top[-1500:]}{err_top[-1500:]}")
        _say(f"[trace] request {term['id']} ({term['seconds']:.3f} s):\n" + out_t.rstrip())
        _say(f"[top] one frame, {len(out_top.splitlines())} lines:\n" + out_top.rstrip())
    finally:
        daemon.request_stop()
        daemon.shutdown()
        obs.disable()
        shutil.rmtree(os.path.dirname(sock), ignore_errors=True)

    # (d) the drift drill: goldens with one artifact digest changed
    bad = json.loads(json.dumps(goldens))
    coord = sorted(bad["goldens"])[0]
    bad["goldens"][coord]["artifact"] = "00000000"
    bad_path = os.path.join(tmp, "goldens_drifted.json")
    with open(bad_path, "w") as fh:
        json.dump(bad, fh)
    drift_events = os.path.join(tmp, "drift_events.jsonl")
    fdir = os.path.join(tmp, "flight")
    metrics.registry().reset()
    obs.configure(drift_events, truncate=True, meta={"tool": "chip_smoke", "device": str(dev)})
    sock = _short_socket()
    env_flight = os.environ.get(flight.ENV_DIR)
    drill = ServeDaemon(ccfg.replace(config_name="chip_smoke_drift"), socket_path=sock,
                        warm_baseline=os.path.join(here, "compile_surface_baseline.json"),
                        canary_interval_s=1.0, canary_goldens=bad_path, flight_dir=fdir,
                        telemetry_window_s=1.0, device=dev, wal=False)
    drill.start()
    try:
        _wait_for(lambda: drill.sentinel.stats()["drift_total"] >= 1, 120.0, "a drift")
        _wait_for(lambda: sum(int(w.get("drift", 0) or 0)
                              for w in drill.aggregator.snapshot()["windows"]) >= 1,
                  30.0, "a window with drift")
        with ServeClient(sock, timeout_s=60.0) as c:
            slo = c.slo()
        drifted = drill.sentinel.stats()
    finally:
        drill.request_stop()
        drill.shutdown()
        obs.flush_metrics()
        obs.disable()
        flight.arm(None)
        if env_flight is None:
            os.environ.pop(flight.ENV_DIR, None)
        else:
            os.environ[flight.ENV_DIR] = env_flight
        shutil.rmtree(os.path.dirname(sock), ignore_errors=True)
    drift_rows = list(read_events(drift_events, kinds=[KIND_DRIFT]))
    dumps = sorted(os.listdir(fdir)) if os.path.isdir(fdir) else []
    named = [d for d in dumps if coord in open(os.path.join(fdir, d)).read()]
    n_drift = metrics.registry().snapshot()["counters"].get("canary.drift", 0)
    window_drift = sum(int(w.get("drift", 0) or 0) for w in slo["telemetry"]["windows"])
    correctness = {o["name"]: o for o in slo["slo"]["objectives"]}["correctness"]
    if (not drift_rows or drift_rows[0].get("coord") != coord or not named or n_drift < 1
            or window_drift < 1 or correctness["state"] != "violated"):
        raise AssertionError(f"drift drill: events {len(drift_rows)}, dumps {dumps}, counter "
                             f"{n_drift}, window drift {window_drift}, correctness "
                             f"{correctness}")
    _say(f"[canary] drift drill at {coord}: {len(drift_rows)} canary.drift event(s) (fields "
         f"{drift_rows[0]['fields']}), flight dump {named[0]} names it, canary.drift "
         f"{int(n_drift)}, windows' drift {window_drift}, correctness {correctness['state']}; "
         f"sentinel drift_coords {json.dumps(drifted['drift_coords'])}")

    # (f) streaming spans: the mid-size scene in chunks of 8, armed and not
    mid = to_scene_tensors(make_scene(num_boxes=4, num_frames=12, image_hw=(240, 320), seed=1))
    mcfg = load_config("scannet", config_name="chip_smoke_mid_stream", distance_threshold=0.03,
                       few_points_threshold=10, streaming_chunk=STREAM_CHUNK)
    off = stream_scene(mid, mcfg, seq_name="mid_stream", device=dev)
    stream_events = os.path.join(tmp, "stream_events.jsonl")
    metrics.registry().reset()
    obs.configure(stream_events, truncate=True, meta={"tool": "chip_smoke", "device": str(dev)})
    try:
        armed = stream_scene(mid, mcfg, seq_name="mid_stream", device=dev)
        obs.flush_metrics()
    finally:
        obs.disable()
    n_chunks = -(-mid.num_frames // STREAM_CHUNK)
    spans = [e["name"] for e in read_events(stream_events, kinds=[KIND_SPAN])]
    stream_counters = {k: v for k, v in metrics.registry().snapshot()["counters"].items()
                       if k.startswith("stream.")}
    if (stream_counters.get("stream.chunks") != n_chunks or spans.count("stream.chunk") != n_chunks
            or spans.count("stream.finalize") != 1 or spans.count("stream.scene") != 1
            or armed.digest != off.digest
            or artifact_digest(armed.objects) != artifact_digest(off.objects)):
        raise AssertionError(f"streaming spans {spans}, counters {stream_counters}, digests "
                             f"{armed.digest} / {off.digest}")
    _say(f"[obs] mid-size stream in {n_chunks} chunks of {STREAM_CHUNK}, armed: "
         f"{spans.count('stream.chunk')} stream.chunk spans, one stream.finalize, counters "
         f"{json.dumps(stream_counters)}; artifact {armed.digest['artifact']} == unarmed")

    for path, data in guarded.items():
        if open(path, "rb").read() != data:
            raise AssertionError(f"{path} changed during the phase")
    shutil.rmtree(tmp, ignore_errors=True)
    _say(f"[obs] {', '.join(os.path.basename(p) for p in guarded)} unchanged; phase 16 in "
         f"{time.perf_counter() - t_phase:.1f} s")
    return {"canary_launches": canary_launches}


def _smi(query: str, fields: str):
    """Rows of ``nvidia-smi --query-<query>=<fields>`` (csv, no header,
    no units)."""
    out = subprocess.run(["nvidia-smi", f"--query-{query}={fields}",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    return [[c.strip() for c in line.split(",")] for line in out.splitlines() if line.strip()]


def _compute_apps() -> dict:
    """{pid: MiB} of the processes that hold a context on a card."""
    return {int(r[0]): float(r[1]) for r in _smi("compute-apps", "pid,used_memory")
            if r and r[0].isdigit()}


def _used_mib() -> float:
    return float(_smi("gpu", "memory.used")[0][0])


def _context_holders(pids) -> tuple:
    """(the pids among ``pids`` that hold a CUDA context, how that was read).
    ``nvidia-smi``'s compute apps when it lists this process (which holds
    one); in a PID namespace it cannot see, the processes that have a card's
    device file open."""
    apps = _compute_apps()
    if os.getpid() in apps:
        return {p for p in pids if p in apps}, f"nvidia-smi compute apps {json.dumps(apps)}"
    held = set()
    for pid in pids:
        try:
            fds = os.listdir(f"/proc/{pid}/fd")
        except OSError:
            continue
        for fd in fds:
            try:
                target = os.readlink(f"/proc/{pid}/fd/{fd}")
            except OSError:
                continue
            if target.startswith("/dev/nvidia") and target[len("/dev/nvidia"):].isdigit():
                held.add(pid)
                break
    return held, (f"nvidia-smi lists no process of this namespace ({json.dumps(apps)}); "
                  f"read the open /dev/nvidiaN files instead")


class _IsoDaemon:
    """One ``python -m maskclustering_tpu_torch.serve --isolate-worker``
    subprocess: its socket, log, events file and config name. With
    ``expect_fail`` (a daemon that must refuse to start) the constructor
    returns once the process is started; the caller waits for ``proc``.
    With ``wait=False`` it returns once the process is started too, and
    ``wait_ready`` blocks until the daemon answers (a daemon that starts
    beside other work)."""

    def __init__(self, here: str, tmp: str, name: str, cfg, args, env=None,
                 expect_fail: bool = False, wait: bool = True):
        import tempfile

        self.name = name
        self.cfg_name = f"chip_smoke_iso_{name}"
        knobs = {k: v for k, v in dataclasses.asdict(cfg).items()
                 if k not in ("config_name", "data_root")}
        cfg_path = os.path.join(tmp, f"{self.cfg_name}.json")
        with open(cfg_path, "w") as fh:
            json.dump(knobs, fh)
        self.sock_dir = tempfile.mkdtemp(prefix="mc17", dir="/tmp")
        self.sock = os.path.join(self.sock_dir, "s.sock")
        self.log_path = os.path.join(tmp, f"{name}.log")
        self.events = os.path.join(tmp, f"{name}_events.jsonl")
        self.pred = os.path.join(tmp, f"prediction_{name}")
        self.child_pids = set()
        full_env = dict(os.environ)
        full_env.update(env or {})
        cmd = [sys.executable, "-m", "maskclustering_tpu_torch.serve", "--config", cfg_path,
               "--socket", self.sock, "--device", "cuda", "--data_root", cfg.data_root,
               "--prediction-root", self.pred, "--journal-dir",
               os.path.join(tmp, f"journals_{name}"), "--obs_events", self.events,
               "--isolate-worker", *args]
        self.t0 = time.perf_counter()
        with open(self.log_path, "w") as log:
            self.proc = subprocess.Popen(cmd, cwd=here, env=full_env, stdout=subprocess.PIPE,
                                         stderr=log, text=True)
        if expect_fail or not wait:
            return
        self.wait_ready()

    def wait_ready(self) -> None:
        """Block until the daemon answers (its worker is warm)."""
        name = self.name
        deadline = time.monotonic() + 600
        while not os.path.exists(self.sock) and self.proc.poll() is None:
            if time.monotonic() > deadline:
                raise AssertionError(f"{name}: daemon never bound its socket")
            time.sleep(0.05)
        if self.proc.poll() is not None:
            raise AssertionError(f"{name}: daemon exited rc {self.proc.returncode}:\n"
                                 + self.log_tail())
        from maskclustering_tpu_torch.serve import ServeClient

        # the socket file appears at bind(), a moment before listen(): a
        # connect in between is refused (seen once, with the host's cores
        # busy), so it is tried again until the daemon listens or exits.
        # The acceptor runs once the worker answered ready.
        while True:
            try:
                with ServeClient(self.sock, timeout_s=600.0) as c:
                    self.ready = c.stats()
                break
            except ConnectionRefusedError:
                if self.proc.poll() is not None:
                    raise AssertionError(f"{name}: daemon exited rc {self.proc.returncode}:\n"
                                         + self.log_tail()) from None
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.05)
        self.ready_s = time.perf_counter() - self.t0
        self.note_children(self.ready)

    def log_tail(self, n: int = 4000) -> str:
        with open(self.log_path) as fh:
            return fh.read()[-n:]

    def note_children(self, stats) -> None:
        panels = (stats.get("pool") or {}).get("workers") or [stats.get("worker") or {}]
        self.child_pids |= {p["pid"] for p in panels if p.get("pid")}

    def stats(self):
        from maskclustering_tpu_torch.serve import ServeClient

        with ServeClient(self.sock, timeout_s=600.0) as c:
            st = c.stats()
        self.note_children(st)
        return st

    def stop(self):
        """Shutdown op, then the digest line the daemon prints last."""
        from maskclustering_tpu_torch.serve import ServeClient

        with ServeClient(self.sock, timeout_s=600.0) as c:
            c.shutdown()
        out, _ = self.proc.communicate(timeout=600)
        if self.proc.returncode != 0:
            raise AssertionError(f"{self.name}: daemon rc {self.proc.returncode}:\n"
                                 + self.log_tail())
        return json.loads(out.strip().splitlines()[-1])

    def kill(self) -> None:
        """Leave nothing running: the daemon, then any child it spawned."""
        import shutil
        import signal

        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(60)
        for pid in self.child_pids:
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass
        shutil.rmtree(self.sock_dir, ignore_errors=True)


def _timed_request(sock: str, scene: str, **kw):
    """One request on its own connection: (terminal, [(seconds since the
    send, event)], wall) — the status events with their arrival times."""
    from maskclustering_tpu_torch.serve import ServeClient

    with ServeClient(sock, timeout_s=300.0) as c:
        t0 = time.perf_counter()
        first = c.request_scene(scene, **kw)
        seen = [(time.perf_counter() - t0, first)]
        term = first
        while term.get("kind") not in ("result", "reject"):
            term = c.recv_event()
            seen.append((time.perf_counter() - t0, term))
    return term, seen, time.perf_counter() - t0


def _states(seen):
    return [ev.get("state") for _, ev in seen if ev.get("kind") == "status"]


def _peak(cuda: dict) -> str:
    """A child's ``torch.cuda.max_memory_allocated``, from its cuda key."""
    peak = cuda.get("max_memory_allocated")
    return "no card" if peak is None else f"{peak / 2**20:.1f} MiB"


def _daemon_counters(events_path: str) -> dict:
    from maskclustering_tpu_torch.obs.events import read_events

    rows = list(read_events(events_path, kinds=["metrics"]))
    return rows[-1]["metrics"]["counters"] if rows else {}


def start_isolated(batch) -> dict:
    """Phase 17(a)'s daemon (its directory and ``_IsoDaemon``), started in
    phase 16 once its timed runs are done, so that its start and its
    child's warm scan run beside the rest of phase 16."""
    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_iso_", dir="/tmp")
    return {"tmp": tmp, "one": _IsoDaemon(here, tmp, "one", batch["cfg"],
                                          ["--warm", BATCH_SCANS[0]], wait=False)}


def isolation_phase(dev, card: str, batch, serve, early: dict) -> dict:
    """Phase 17: the crash-contained topology on the card. Every daemon is
    a ``python -m maskclustering_tpu_torch.serve --isolate-worker``
    subprocess serving phase 10's scans with phase 10's config; ``early``
    holds (a)'s daemon, started in phase 16 (``start_isolated``). Every
    check goes through ``expect``, which counts it; the phase prints the
    count, its parts' seconds and the export retries it saw (0: two workers
    exporting one scene at once write temporary files of their own)."""
    import shutil
    import signal

    import torch

    from maskclustering_tpu_torch.datasets import get_dataset
    from maskclustering_tpu_torch.models.streaming import stream_scene
    from maskclustering_tpu_torch.obs.digest import artifact_digest
    from maskclustering_tpu_torch.serve import ServeClient, protocol
    from maskclustering_tpu_torch.serve.admission import AdmissionQueue
    from maskclustering_tpu_torch.serve.pool import WorkerPool
    from maskclustering_tpu_torch.serve.router import Router

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    tmp = early["tmp"]
    cfg = batch["cfg"]
    want = {scene: dg["artifact"] for scene, (dg, _) in batch["scans"].items()}
    first = BATCH_SCANS[0]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # this process's cached blocks out of the readings
    daemons = [early["one"]]
    parts, t_part = {}, [t_phase]
    counted = {"checks": 0, "retries": 0}
    count_lock = threading.Lock()

    def part(name):
        now = time.perf_counter()
        parts[name] = round(now - t_part[0], 1)
        t_part[0] = now

    def expect(ok, msg):
        """One check of the phase: counted, and raised when it fails
        (``msg`` a string, or a callable that makes one)."""
        with count_lock:
            counted["checks"] += 1
        if not ok:
            raise AssertionError(msg() if callable(msg) else msg)

    def spawn(name, args, **kw):
        daemons.append(_IsoDaemon(here, tmp, name, cfg, args, **kw))
        return daemons[-1]

    def check_ok(term, scene, label, digest=None, export_race=False):
        """A served scan: ok with its digest. ``export_race``: one of
        several requests of one scene that two slices export into one
        prediction root at once; its retries (attempts past the first) are
        booked as export retries."""
        want_dg = digest or want[scene]
        expect(term.get("kind") == "result" and term.get("status") == "ok"
               and term["digest"]["artifact"] == want_dg,
               lambda: f"{label}: {scene} answered {term}, want digest {want_dg}")
        if export_race:
            with count_lock:
                counted["retries"] += int(term.get("attempts", 1)) - 1

    try:
        # (a) one isolated worker: spawn to ready, two scans, the pipe's
        # cost beside phase 15's in-thread figures, the parent device-free
        one = early["one"]
        one.wait_ready()
        w = one.ready["worker"]
        expect(not w["cuda"]["build_s"], f"the child built kernels: {w['cuda']}")
        held, how = _context_holders({w["pid"], one.proc.pid, os.getpid()})
        expect(held == {w["pid"], os.getpid()},
               f"contexts held by {held} ({how}): child {w['pid']}, daemon {one.proc.pid}, "
               f"this process {os.getpid()}")
        _say(f"[iso] {card}: daemon pid {one.proc.pid} started in phase 16 (answered here "
             f"{one.ready_s:.2f} s after its start), spawn to ready "
             f"{one.ready['warmup_s']:.2f} s, the child's own warm-up {w['warmup_s']:.2f} s, no "
             f"build in the child ({json.dumps(w['cuda'])}); the child {w['pid']} holds a "
             f"context and the daemon holds none ({how})")
        # (b)'s daemon spawns and warms beside (a)'s requests. Its memory
        # readings take (a)'s child as it is now, warm: serving the scene it
        # warmed on reuses its cached blocks, so it holds the same memory
        # until (a)'s daemon stops, after (b)'s last reading
        victim = BATCH_SCANS[1]
        mem0 = _used_mib()
        crash_d = spawn("crash", ["--warm", first, "--fault-plan", f"crash:{victim}.device:1",
                                  "--set", f"worker_heartbeat_s={ISO_CRASH_HB_S:g}"], wait=False)
        gaps, stop_sampler = [], threading.Event()

        def sampler():
            with ServeClient(one.sock, timeout_s=60.0) as c:
                while not stop_sampler.is_set():
                    gaps.append(c.stats()["worker"]["hb_age_s"])
                    time.sleep(HB_SAMPLE_S)

        th = threading.Thread(target=sampler, name="hb-sampler")
        th.start()
        try:
            rows = [(scene, *_timed_request(one.sock, scene)) for scene in ISO_SCANS]
        finally:
            stop_sampler.set()
            th.join(60.0)
        in_thread = {scene: (secs, wall) for scene, secs, wall in serve["seq"]}
        for scene, term, seen, wall in rows:
            check_ok(term, scene, "isolated")
            expect(_states(seen) == ["running"], f"isolated {scene}: {seen}")
            _say(f"[iso] {scene}: ok in {term['seconds']:.3f} s (client wall {wall:.3f} s, "
                 f"(b)'s daemon warming beside it) against phase 15's in-thread "
                 f"{in_thread[scene][0]:.3f} s (wall {in_thread[scene][1]:.3f} s); digest "
                 f"{term['digest']['artifact']} == phase 10's")
        max_gap = max(gaps)
        # the first scan again with no status polling beside it
        quiet = [(scene, *_timed_request(one.sock, scene)) for scene in BATCH_SCANS[:1]]
        for scene, term, _, wall in quiet:
            check_ok(term, scene, "isolated, unpolled")
        _say("[iso] the first scan with no status polling: " + ", ".join(
            f"{scene} {term['seconds']:.3f} s (wall {wall:.3f} s)"
            for scene, term, _, wall in quiet))
        expect(max_gap < ISO_WEDGE_HB_S, f"a healthy busy child went {max_gap:.3f} s silent")
        part("a")

        # (b) crash drill: the child SIGKILLs itself at the device seam
        d = crash_d
        d.wait_ready()
        pid1, mem1 = d.ready["worker"]["pid"], _used_mib()
        term, seen, wall = _timed_request(d.sock, victim)
        check_ok(term, victim, "crash drill")
        expect(_states(seen) == ["running", "worker_crash", "running"] and term["rung"] == 1,
               f"crash drill events {seen}")
        t_crash = next(t for t, ev in seen if ev.get("state") == "worker_crash")
        t_again = [t for t, ev in seen if ev.get("state") == "running"][1]
        st = d.stats()
        pid2, mem2 = st["worker"]["pid"], _used_mib()
        held, how = _context_holders({pid1, pid2})
        # the dead child's context is gone: only one child's memory is held
        expect(pid2 != pid1 and held == {pid2} and mem2 - mem0 <= 1.5 * (mem1 - mem0),
               f"after the crash: pids {pid1} -> {pid2}, contexts {held} ({how}), used "
               f"{mem0} / {mem1} -> {mem2} MiB")
        d.stop()
        mem3 = _used_mib()
        counters = _daemon_counters(d.events)
        drill = {k: counters.get(f"serve.{k}") for k in
                 ("worker_crashes", "requests_requeued", "worker_respawns")}
        expect(drill == {k: 1.0 for k in drill} and abs(mem3 - mem0) <= MEM_SLACK_MIB,
               f"crash drill counters {drill}, used {mem0} -> {mem3} MiB")
        _say(f"[iso] crash:{victim}.device:1 (heartbeat {ISO_CRASH_HB_S:g} s): running, "
             f"worker_crash at {t_crash:.2f} s, running again at {t_again:.2f} s (the respawn, "
             f"kill to ready and re-dispatch, {t_again - t_crash:.2f} s), ok at rung "
             f"{term['rung']} in {wall:.2f} s, digest == phase 10's; counters "
             f"{json.dumps(drill)}; the dead pid {pid1} holds no context, the respawned {pid2} "
             f"does ({how.split(' (')[0]}); card used {mem0:.0f} MiB before the spawn ((a)'s "
             f"warm child in it), {mem1:.0f} with the child, {mem2:.0f} after the respawn, "
             f"{mem3:.0f} after the drain")
        # (a)'s daemon stops now that (b)'s readings are done
        digest_line = one.stop()
        launches = digest_line["worker"]["cuda"]["launches"]
        served = 1 + len(ISO_SCANS) + len(quiet)  # the warm scan, then the requests
        expect(all(launches.get(n) == served for n in ASSOCIATION_KERNELS),
               f"the child's bye launches {launches}, want {served} each")
        _say(f"[iso] (a)'s child's bye: launches {json.dumps(launches)} (the warm scan and "
             f"{served - 1} requests: one of each association kernel a scan), peak "
             f"{_peak(digest_line['worker']['cuda'])}; the "
             f"longest heartbeat age sampled while it served ({len(gaps)} samples every "
             f"{HB_SAMPLE_S} s) {max_gap:.3f} s, {ISO_WEDGE_HB_S - max_gap:.3f} s under the "
             f"{ISO_WEDGE_HB_S:g} s wedge budget")
        part("b")

        # (c) wedge drill: the child silences its heartbeat and hangs
        victim = BATCH_SCANS[2]
        # cut: no warm scan in this daemon's child or its respawn (the drill
        # reads no memory, and (a) and (d) hold the warm path)
        d = spawn("wedge", ["--fault-plan", f"wedge:{victim}.device:1",
                            "--set", f"worker_heartbeat_s={ISO_WEDGE_HB_S:g}"])
        # (d)'s pool starts and warms beside the wedge drill, which reads
        # no memory or context
        crash_scene = BATCH_SCANS[2]
        pool_d = spawn("pool", ["--workers", "2", "--tenants", POOL_TENANTS, "--warm", first,
                                "--fault-plan", f"crash:{crash_scene}.device:1",
                                "--set", f"worker_heartbeat_s={ISO_CRASH_HB_S:g}"], wait=False)
        term, seen, wall = _timed_request(d.sock, victim)
        check_ok(term, victim, "wedge drill")
        expect(_states(seen) == ["running", "worker_crash", "running"],
               f"wedge drill events {seen}")
        t_run = next(t for t, ev in seen if ev.get("state") == "running")
        t_crash = next(t for t, ev in seen if ev.get("state") == "worker_crash")
        detail = next(ev for _, ev in seen if ev.get("state") == "worker_crash")["detail"]
        d.stop()
        _say(f"[iso] wedge:{victim}.device:1 (heartbeat {ISO_WEDGE_HB_S:g} s): detected "
             f"{t_crash - t_run:.2f} s after the request started ({detail!r}), SIGKILL, "
             f"respawn, ok in {wall:.2f} s, digest == phase 10's")
        part("c")

        # (d) a pool of two on the one card: both slices share cuda:0
        d = pool_d
        d.wait_ready()
        # beside (d), which reads no memory or context: a carve the one card
        # cannot hold, refused at start (checked after (d)); (e)'s stream
        # failover and the order burst's pool in this process, each in a
        # thread of its own once started
        bad = spawn("carve", ["--workers", "2", "--carve", "2x1"], expect_fail=True)
        sdir = os.path.join(tmp, "stream_state")
        stream_d = spawn("stream", ["--workers", "2", "--stream-state", sdir,
                                    "--fault-plan", f"stall:{MID_SCAN}.chunk:2"],
                         env={"MCT_FAULT_STALL_S": str(ISO_STREAM_STALL_S)}, wait=False)
        ocfg = cfg.replace(config_name="chip_smoke_iso_order", serve_workers=2,
                           serve_tenants="a:3,b:1")
        pool = WorkerPool(ocfg, AdmissionQueue(32), Router(ocfg), device="cuda",
                          start_timeout_s=600.0, poll_s=0.1)
        side = {}

        def beside(name, fn):
            """Run ``fn`` in a thread beside (d); its error is raised after."""
            def run():
                t0 = time.perf_counter()
                try:
                    side[name] = {"out": fn()}
                except BaseException as e:  # noqa: BLE001 — raised after (d)
                    side[name] = {"error": e}
                side[name]["s"] = time.perf_counter() - t0
            # a daemon thread: a failure of (d) ends the script without it
            th = threading.Thread(  # mct-thread: abandon(joined with a bound by the phase after (d); on a failure of (d) the script ends without it)
                target=run, name=f"iso-{name}", daemon=True)
            th.start()
            return th

        def order_burst():
            """The stride scheduler's dispatch order on real children: the
            pool in this process, dispatch held until the whole burst is
            queued."""
            order, answers = [], {}
            book = pool._book_dispatch
            pool._book_dispatch = lambda req, wid: (order.append(req.tenant), book(req, wid))[1]
            pool._pause.set()
            try:
                try:
                    pool.start()
                    failed = None
                except Exception as e:  # noqa: BLE001 — the check below
                    failed = e
                expect(failed is None, f"the order burst's pool did not start: {failed!r}")
                n = 0
                for tenant, count in ORDER_BURST.items():
                    for _ in range(count):
                        req = protocol.build_request({"op": "scene", "scene": MID_SCAN,
                                                      "tenant": tenant}, f"o-{n:03d}")
                        req.send = lambda ev, rid=req.id: (
                            answers.__setitem__(rid, ev)
                            if ev.get("kind") in ("result", "reject") else None)
                        pool.admit(req)
                        n += 1
                pool._pause.clear()
                _wait_for(lambda: len(answers) == n, 600, "the order burst's answers")
            finally:
                pool.stop(timeout_s=120.0)
            expect(all(a.get("status") == "ok" for a in answers.values()),
                   f"order burst answers {answers}")
            for a in answers.values():  # eight of one scene on two slices
                with count_lock:
                    counted["retries"] += int(a.get("attempts", 1)) - 1
            windows = [order[:4 * k].count("a") for k in range(1, n // 4 + 1)]
            expect(windows == [3 * k for k in range(1, n // 4 + 1)], f"dispatch order {order}")
            return order, n

        def stream_failover():
            """(e): a stream in chunks on a pool with ``--stream-state``,
            its owner SIGKILLed with the second chunk in flight."""
            sd = stream_d
            sd.wait_ready()
            with ServeClient(sd.sock, timeout_s=600.0) as c:
                one_chunk, _ = c.stream_chunk(MID_SCAN, chunk=STREAM_CHUNK)
            expect(one_chunk.get("status") == "ok" and not one_chunk.get("done"),
                   f"stream chunk 1: {one_chunk}")
            owners = [wk for wk in sd.stats()["pool"]["workers"] if wk["open_streams"]]
            expect(len(owners) == 1 and owners[0]["worker_id"] == 0, f"stream owners {owners}")
            owner_pid = owners[0]["pid"]
            with ServeClient(sd.sock, timeout_s=600.0) as c:
                c.send({"op": "stream_chunk", "scene": MID_SCAN, "chunk": STREAM_CHUNK})
                seen = [c.recv_event()]
                while seen[-1].get("state") != "running":
                    seen.append(c.recv_event())
                os.kill(owner_pid, signal.SIGKILL)
                t_kill = time.perf_counter()
                while seen[-1].get("kind") not in ("result", "reject"):
                    seen.append(c.recv_event())
                resume_s = time.perf_counter() - t_kill
                two = seen[-1]
                end, _ = c.stream_end(MID_SCAN)
            crash_ev = [ev for ev in seen if ev.get("state") == "worker_crash"]
            st = sd.stats()
            expect(two.get("status") == "ok" and two.get("done") and crash_ev
                   and crash_ev[0].get("resuming") and end.get("status") == "ok",
                   f"stream failover: {seen} {end}")
            final = sd.stop()
            ds = get_dataset("scannet", MID_SCAN, data_root=cfg.data_root)
            tensors = ds.load_scene_tensors(cfg.step)
            ref = stream_scene(tensors, cfg.replace(streaming_chunk=STREAM_CHUNK),
                               seq_name=MID_SCAN, device=dev)
            served_dg = _served_artifact_digest(cfg.data_root, MID_SCAN, sd.cfg_name,
                                                tensors.num_points)
            expect(served_dg == artifact_digest(ref.objects),
                   f"failed-over stream {served_dg} != in-process "
                   f"{artifact_digest(ref.objects)}")
            return owner_pid, seen, resume_s, final, st, served_dg

        threads = [beside("order", order_burst), beside("stream", stream_failover)]
        t_d = time.perf_counter()
        jobs = [(BATCH_SCANS[0], None), ("chip_smoke_serve_cold", SERVE_COLD_SPEC),
                (BATCH_SCANS[1], None)]
        results, errors = [], []

        def client(i):
            # cut: one request a client (two before), each bucket still sent
            try:
                scene, spec = jobs[i]
                term = _timed_request(d.sock, scene, synthetic=spec, tenant="a")[0]
                results.append((scene, term))
            except Exception as e:  # noqa: BLE001 — surfaced below
                errors.append(repr(e))

        clients = [threading.Thread(target=client, args=(i,)) for i in range(3)]
        t0 = time.perf_counter()
        for th in clients:
            th.start()
        for th in clients:
            th.join(600.0)
        wall = time.perf_counter() - t0
        expect(not errors and len(results) == len(jobs), f"pool clients: {errors} {results}")
        for scene, term in results:
            check_ok(term, scene, "pool", serve["cold_digest"] if scene.endswith("cold")
                     else None)
        # the cold bucket once more, twice in turn: known to the router now,
        # a miss on the slice that first sees it, then a hit
        for _ in range(2):
            term = _timed_request(d.sock, jobs[1][0], synthetic=SERVE_COLD_SPEC,
                                  tenant="a")[0]
            check_ok(term, jobs[1][0], "pool", serve["cold_digest"])
        st = d.stats()
        per = [wk["dispatched"] for wk in st["pool"]["workers"]]
        sched = st["pool"]["scheduler"]
        expect(len(per) == 2 and all(per) and sched["affinity_hits"],
               f"pool slices dispatched {per}, scheduler {sched}")
        _say(f"[iso] pool of 2 on one card ({card}; both slices share cuda:0, so seconds a "
             f"request are not a throughput figure): 3 clients x 1 request over two buckets "
             f"in {wall:.2f} s and the cold bucket twice more, every digest == its "
             f"reference; per-worker dispatched {per}, "
             f"affinity hits {sched['affinity_hits']} misses {sched['affinity_misses']}; "
             f"peak at ready (a full-size warm scan) "
             + ", ".join(f"worker {wk['worker_id']} {_peak(wk['cuda'])}"
                         for wk in st["pool"]["workers"]))
        # quota: the slices' feeds and flights take 6 requests, 2 more a
        # queue in the pool, then b queues 2 and its third is refused. cut
        # (pays for phase 24): the burst is of the cold bucket's mid-size
        # scan, not of full-size scans; all 11 are answered or acked within
        # milliseconds, long before the first of them finishes
        conns = [ServeClient(d.sock, timeout_s=600.0) for _ in range(11)]
        cold = jobs[1][0]
        try:
            acks = [c.request_scene(cold, synthetic=SERVE_COLD_SPEC, tenant="a")
                    for c in conns[:8]]
            acks += [c.request_scene(cold, synthetic=SERVE_COLD_SPEC, tenant="b")
                     for c in conns[8:]]
            kinds = [a.get("kind") for a in acks]
            expect(kinds == ["ack"] * 10 + ["reject"] and acks[-1].get("reason") == "quota",
                   f"quota burst answers {acks}")
            for c in conns[:10]:  # ten of one scene on two slices
                check_ok(c.wait_result(), cold, "quota burst", serve["cold_digest"],
                         export_race=True)
        finally:
            for c in conns:
                c.close()
        _say(f"[iso] quota: 8 a and 3 b requests of the cold bucket at once: 10 ack, the "
             f"third queued b a typed {acks[-1]['reason']!r} reject ({acks[-1]['detail']}); "
             f"every admitted one ok with its digest")
        # a crash on slice 0 reroutes its victim to slice 1: with both
        # slices idle, a scene of no known bucket routes to slice 0
        _wait_for(lambda: not any(wk.get("inflight") or wk.get("feed_depth")
                                  for wk in d.stats()["pool"]["workers"]), 120, "an idle pool")
        term, seen, wall = _timed_request(d.sock, crash_scene, tenant="a")
        check_ok(term, crash_scene, "pool crash")
        st = d.stats()
        expect("worker_crash" in _states(seen)
               and st["pool"]["scheduler"]["crash_reroutes"] == 1,
               f"pool crash: {seen} {st['pool']['scheduler']}")
        _say(f"[iso] crash:{crash_scene}.device:1 on slice 0: states {_states(seen)}, "
             f"crash_reroutes {st['pool']['scheduler']['crash_reroutes']}, ok in {wall:.2f} s "
             f"on the neighbour, digest == phase 10's")
        # recarve to one worker with a request in flight
        inflight = {}

        def slow_client():
            inflight["term"] = _timed_request(d.sock, BATCH_SCANS[0], tenant="a")

        th = threading.Thread(target=slow_client)
        th.start()
        _wait_for(lambda: any(wk.get("inflight") for wk in
                              d.stats()["pool"]["workers"]), 120, "a request in flight")
        t0 = time.perf_counter()
        with ServeClient(d.sock, timeout_s=600.0) as c:
            out = c.recarve(workers=1)
        recarve_s = time.perf_counter() - t0
        th.join(600.0)
        check_ok(inflight["term"][0], BATCH_SCANS[0], "in flight across the recarve")
        expect(out.get("kind") == "recarve" and out.get("ok")
               and d.stats()["worker"]["pool"] == 1, f"recarve: {out}")
        final = d.stop()
        _say(f"[iso] recarve to 1 worker with a request in flight: it drained ok, recarve "
             f"answered in {recarve_s:.2f} s; after it the one slice's bye: launches "
             f"{json.dumps(final['pool']['workers'][0]['cuda']['launches'])}, peak "
             f"{_peak(final['pool']['workers'][0]['cuda'])}")
        bad.proc.wait(600)
        msg = "serve_carve 2x1 needs 2 chips but the backend has 1"
        expect(bad.proc.returncode != 0 and msg in bad.log_tail(20000),
               lambda: f"carve 2x1: rc {bad.proc.returncode}\n{bad.log_tail()}")
        _say(f"[iso] --workers 2 --carve 2x1 refused at start (rc {bad.proc.returncode}): {msg}")
        part("d")
        for th in threads:
            th.join(900.0)
        for name in ("order", "stream"):
            res = side.get(name) or {"error": AssertionError(f"{name} beside (d) never ended")}
            if "error" in res:
                raise res["error"]
        order, n = side["order"]["out"]
        _say(f"[iso] weighted-fair a:3 b:1 on two real slices (beside (d), "
             f"{side['order']['s']:.1f} s): dispatch order {''.join(order)} (3 a to 1 b in "
             f"every window of 4, as the JAX stride scheduler gives), {n} ok")
        # (e) stream failover, beside (d)
        owner_pid, seen, resume_s, final, st, served_dg = side["stream"]["out"]
        _say(f"[iso] stream {MID_SCAN} in chunks of {STREAM_CHUNK} on the pool (beside (d), "
             f"{side['stream']['s']:.1f} s): owner slice 0 (pid {owner_pid}) SIGKILLed with "
             f"chunk 2 in flight, resumed from the snapshot on the survivor (states "
             f"{[ev.get('state') for ev in seen if ev.get('kind') == 'status']}, "
             f"{resume_s:.2f} s to its answer, streams_resumed "
             f"{final['worker']['streams_resumed']}, crash_reroutes "
             f"{st['pool']['scheduler']['crash_reroutes']}); final digest {served_dg} == the "
             f"in-process stream_scene's")
        # two slices exporting one scene into one root at once (the quota
        # burst and the order burst) write temporary files of their own
        expect(counted["retries"] == 0,
               f"{counted['retries']} export retries: two workers raced on one artifact")
        part("d+e waits")
        _say(f"[iso] export retries seen over the quota and order bursts (ten and eight "
             f"requests of one scene on two slices exporting into one root): "
             f"{counted['retries']}")
    except BaseException:
        for dmn in daemons:
            _say(f"[iso] {dmn.name} daemon's log, last lines:\n{dmn.log_tail()}")
        raise
    finally:
        for dmn in daemons:
            dmn.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    _say(f"[iso] phase 17 in {time.perf_counter() - t_phase:.1f} s: {counted['checks']} checks "
         f"held; parts (s) {json.dumps(parts)} ((b)'s daemon spawned beside (a), (e) and the "
         f"order burst beside (d))")
    return {"launches": launches}


def jpeg_probe_image():
    """Phase 18's seeded probe image: 45x61 (partial MCUs on both edges),
    gradients under seeded noise."""
    import numpy as np

    rng = np.random.default_rng(20261017)
    y, x = np.mgrid[0:45, 0:61]
    img = np.stack([x * 4, y * 5, (x + y) * 2], axis=-1) + rng.integers(0, 24, (45, 61, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _sha(data: bytes) -> str:
    import hashlib

    return hashlib.sha256(data).hexdigest()


def write_capture(path: str, scene, n_frames: int):
    """Phase 18a: a version-4 ``.sens`` capture of the scene's first
    ``n_frames`` frames through the port's ``write_sens``: zlib uint16 depth
    in millimetres, phase 11's textured 968x1296 colour frames as JPEG at
    INGEST_QUALITY, the poses and the depth intrinsics. Returns (header,
    frames, the captured uint16 depths, the colour payloads, encode
    seconds)."""
    import zlib

    import numpy as np

    from maskclustering_tpu_torch.io.jpeg import encode_jpeg
    from maskclustering_tpu_torch.preprocess.scannet import SensFrame, SensHeader, write_sens

    h, w = scene.depths.shape[1:]
    intr = np.eye(4, dtype=np.float32)
    intr[:3, :3] = scene.intrinsics[0]
    intr_color = intr.copy()
    intr_color[0] *= COLOR_HW[1] / w
    intr_color[1] *= COLOR_HW[0] / h
    header = SensHeader(
        sensor_name="chip_smoke", intrinsic_color=intr_color,
        extrinsic_color=np.eye(4, dtype=np.float32), intrinsic_depth=intr,
        extrinsic_depth=np.eye(4, dtype=np.float32), color_compression="jpeg",
        depth_compression="zlib_ushort", color_width=COLOR_HW[1], color_height=COLOR_HW[0],
        depth_width=w, depth_height=h, depth_shift=INGEST_DEPTH_SHIFT, num_frames=n_frames)
    mm = np.round(scene.depths[:n_frames] * INGEST_DEPTH_SHIFT).astype(np.uint16)
    payloads, enc_s = [], 0.0
    for f in range(n_frames):
        img = textured_frame(scene.segmentations[f], f)
        t0 = time.perf_counter()
        payloads.append(encode_jpeg(img, INGEST_QUALITY))
        enc_s += time.perf_counter() - t0
    frames = [SensFrame(index=f, camera_to_world=scene.cam_to_world[f].astype(np.float32),
                        timestamp_color=f, timestamp_depth=f, color_bytes=payloads[f],
                        depth_bytes=zlib.compress(mm[f].tobytes())) for f in range(n_frames)]
    write_sens(path, header, frames)
    return header, frames, mm, payloads, enc_s


def ingest_configs(root: str) -> dict:
    """Phase 18's two configurations over the exported scan: the default
    (with phase 8's neighbour cap) and the exact one."""
    from maskclustering_tpu_torch.config import load_config

    base = load_config("scannet", data_root=root, config_name="chip_smoke_ingest",
                       step=INGEST_FRAME_SKIP, distance_threshold=0.01,
                       post_neighbor_cap=FULL_NEIGHBOR_CAP, cropformer_path="grid")
    return {"default": base,
            "exact": base.replace(config_name="chip_smoke_ingest_exact",
                                  use_exact_ball_query=True, device_postprocess=False)}


def export_capture(tmp: str, scene):
    """Phase 18a-b: the capture of ``scene`` written to ``tmp`` and exported
    at INGEST_FRAME_SKIP under ``<tmp>/data``, with the scene's cloud
    beside it. Returns (data root, scan dir, capture path, header, frames,
    captured uint16 depths, colour payloads, encode s, write s, export s)."""
    from maskclustering_tpu_torch.io.ply import write_ply_points
    from maskclustering_tpu_torch.preprocess.scannet import export_sens_scene

    sens = os.path.join(tmp, "capture.sens")
    t0 = time.perf_counter()
    header, frames, mm, payloads, enc_s = write_capture(sens, scene, scene.depths.shape[0])
    write_s = time.perf_counter() - t0
    root = os.path.join(tmp, "data")
    out = os.path.join(root, "scannet", "processed", INGEST_SCAN)
    t0 = time.perf_counter()
    n_exp = export_sens_scene(sens, out, frame_skip=INGEST_FRAME_SKIP)
    export_s = time.perf_counter() - t0
    if n_exp != len(range(0, len(frames), INGEST_FRAME_SKIP)):
        raise AssertionError(f"exported {n_exp} of {len(frames)} frames at skip "
                             f"{INGEST_FRAME_SKIP}")
    write_ply_points(os.path.join(out, f"{INGEST_SCAN}_vh_clean_2.ply"), scene.scene_points)
    return root, out, sens, header, frames, mm, payloads, enc_s, write_s, export_s


def _cluster_export(cfg, device, pred_root: str):
    """``run_pipeline`` with the masks and cluster steps over phase 18's
    exported scan; fails unless it is ok with objects. Returns (its
    SceneStatus, the run's wall seconds)."""
    from maskclustering_tpu_torch.run import run_pipeline

    t0 = time.perf_counter()
    rep = run_pipeline(cfg, [INGEST_SCAN], steps=("masks", "cluster"), resume=False,
                       journal=False, prediction_root=pred_root, device=device)
    wall = time.perf_counter() - t0
    (st,) = rep.scenes
    if not rep.ok or st.status != "ok" or st.num_objects <= 0:
        raise AssertionError(f"{cfg.config_name} on {device}: {st.status}, {st.num_objects} "
                             f"objects, {st.error[-300:]} {rep.step_errors}")
    return st, wall


def _pinned(st) -> dict:
    return {"objects": st.num_objects, "artifact": st.digest["artifact"],
            "plane": st.digest["plane"]}


def ingest_phase(dev, card: str, scene) -> dict:
    """Phase 18: a ``.sens`` capture exported, masked on the card and
    clustered on the card, each digest held to the CPU route's
    (INGEST_CPU_DIGESTS). Returns the kernels' launches while the exported
    scan is clustered on the card."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from maskclustering_tpu_torch.datasets import get_dataset
    from maskclustering_tpu_torch.device import synchronize
    from maskclustering_tpu_torch.io.image import decode_rgb, read_rgb, resize_bilinear, \
        write_depth_png
    from maskclustering_tpu_torch.io.jpeg import decode_jpeg, encode_jpeg
    from maskclustering_tpu_torch.io.png import read_png
    from maskclustering_tpu_torch.mask_prediction import GridSegmenter, predict_scene_masks
    from maskclustering_tpu_torch.ops import cuda as kernels
    from maskclustering_tpu_torch.preprocess.scannet import export_sens_scene, write_sens
    from maskclustering_tpu_torch.run import check_masks

    t_phase = time.perf_counter()
    probe = _sha(encode_jpeg(jpeg_probe_image(), INGEST_QUALITY))
    if probe != JPEG_PROBE_SHA256:
        raise AssertionError(f"the probe image's JPEG hashes to {probe}, not PIL's "
                             f"{JPEG_PROBE_SHA256}")
    _say(f"[ingest] the probe image's quality-{INGEST_QUALITY} JPEG == PIL's bytes (SHA-256 "
         f"{probe[:16]}...)")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ingest_")
    try:
        # (a) the capture and (b) its export at the JAX default frame skip
        (root, out, sens, header, frames, mm, payloads, enc_s, write_s,
         export_s) = export_capture(tmp, scene)
        n_frames = len(frames)
        _say(f"[ingest] capture: {n_frames} frames, {os.path.getsize(sens)} bytes written in "
             f"{write_s:.2f} s, of it the colour encode {enc_s:.2f} s ({enc_s / n_frames:.3f} "
             f"s a {COLOR_HW[0]}x{COLOR_HW[1]} q{INGEST_QUALITY} frame, "
             f"{sum(map(len, payloads)) / n_frames:.0f} bytes a frame)")
        kept = list(range(0, n_frames, INGEST_FRAME_SKIP))
        for f in kept:
            if not np.array_equal(read_png(os.path.join(out, "depth", f"{f}.png")), mm[f]):
                raise AssertionError(f"exported depth {f} != the captured depth")
            with open(os.path.join(out, "color", f"{f}.jpg"), "rb") as fh:
                got = _sha(fh.read())
            if got != _sha(encode_jpeg(decode_jpeg(payloads[f]), INGEST_QUALITY)):
                raise AssertionError(f"exported colour {f} != encode(decode(payload))")
        # the parts of one frame's export, timed alone
        t = {}
        t0 = time.perf_counter()
        rgb = decode_rgb(payloads[0])
        t["decode"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        encode_jpeg(rgb, INGEST_QUALITY)
        t["encode"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        small = resize_bilinear(rgb, *INGEST_RESIZE_HW)
        t["resize"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        write_depth_png(os.path.join(tmp, "d.png"), frames[0].depth(header))
        t["depth"] = time.perf_counter() - t0
        # once more on the first frame alone, resized: the bilinear path
        one = os.path.join(tmp, "one.sens")
        write_sens(one, dataclasses.replace(header, num_frames=1), frames[:1])
        resized = os.path.join(tmp, "resized")
        export_sens_scene(one, resized, frame_skip=INGEST_FRAME_SKIP,
                          image_size=INGEST_RESIZE_HW)
        with open(os.path.join(resized, "color", "0.jpg"), "rb") as fh:
            if _sha(fh.read()) != _sha(encode_jpeg(small, INGEST_QUALITY)):
                raise AssertionError("the resized export != encode(resize_bilinear(decode))")
        if read_rgb(os.path.join(resized, "color", "0.jpg")).shape != INGEST_RESIZE_HW + (3,):
            raise AssertionError("the resized export has another size")
        _say(f"[ingest] export: {len(kept)} of {n_frames} frames (skip {INGEST_FRAME_SKIP}) in "
             f"{export_s:.2f} s, {export_s / len(kept):.3f} s a frame; depth PNGs == the "
             f"capture, colour == encode(decode(payload)); one frame's parts (s): decode "
             f"{t['decode']:.3f}, encode {t['encode']:.3f}, resize {COLOR_HW} -> "
             f"{INGEST_RESIZE_HW} {t['resize']:.3f}, depth {t['depth']:.4f}; the resized "
             f"export == encode(resize_bilinear(decode))")

        # (c) the masks step on the card, every id-map held against the CPU's
        cfgs = ingest_configs(root)
        t0 = time.perf_counter()
        missing = check_masks(cfgs["default"], [INGEST_SCAN],
                              predictor_spec=cfgs["default"].cropformer_path, device=dev)
        masks_s = time.perf_counter() - t0
        if missing:
            raise AssertionError(f"the masks step left {missing} without masks")
        ds = get_dataset("scannet", INGEST_SCAN, data_root=root)
        largest = max(int(read_png(os.path.join(ds.segmentation_dir, f"{f}.png")).max())
                      for f in kept)
        if largest == 0:
            raise AssertionError("the grid segmenter found no mask")
        card_seg = GridSegmenter(device=dev)
        rgb = ds.get_rgb(kept[0])
        card_seg(rgb)  # warm
        synchronize(dev)
        t0 = time.perf_counter()
        regions = card_seg(rgb)[0].shape[0]
        synchronize(dev)
        card_ms = (time.perf_counter() - t0) * 1e3
        # the cpu's id-maps, on a thread beside (d)
        cpu_dir = os.path.join(tmp, "cpu_masks")

        def cpu_masks():
            t0 = time.perf_counter()
            predict_scene_masks(ds, GridSegmenter(device="cpu"), stride=INGEST_FRAME_SKIP,
                                output_dir=cpu_dir)
            return time.perf_counter() - t0

        cpu_pool = ThreadPoolExecutor(1)
        cpu_job = cpu_pool.submit(cpu_masks)

        # (d) the exported scan clustered on the card, default and exact,
        # each held to the CPU route's digest; the launches of both runs are
        # the kernels' ingest launches
        launches = {}
        for label, cfg in cfgs.items():
            kernels.LAUNCHES.reset()
            st, wall = _cluster_export(cfg, dev, os.path.join(tmp, "pred"))
            got = dict(kernels.LAUNCHES.counts)
            for k, v in got.items():
                launches[k] = launches.get(k, 0) + v
            if _pinned(st) != INGEST_CPU_DIGESTS[label]:
                raise AssertionError(f"{label} on {dev}: {_pinned(st)} != the cpu route's "
                                     f"{INGEST_CPU_DIGESTS[label]}")
            _say(f"[ingest] {label} on {dev}: {st.num_objects} objects, digest "
                 f"{st.digest['artifact']} (plane {st.digest['plane']}) == the cpu route's, "
                 f"scene {st.seconds:.2f} s, run {wall:.2f} s; launches {json.dumps(got)}")
        for k in ASSOCIATION_KERNELS + ("ball_query",):
            if not launches.get(k):
                raise AssertionError(f"clustering the exported scan launched no {k}")
        t0 = time.perf_counter()
        cpu_s = cpu_job.result(timeout=600)
        cpu_pool.shutdown()
        for f in kept:
            with open(os.path.join(cpu_dir, f"{f}.png"), "rb") as a, \
                    open(os.path.join(ds.segmentation_dir, f"{f}.png"), "rb") as b:
                if a.read() != b.read():
                    raise AssertionError(f"frame {f}: the cuda id-map != the cpu id-map")
        _say(f"[ingest] masks step ('grid' on {dev}): {len(kept)} id-maps in {masks_s:.2f} s; "
             f"the segmenter {card_ms:.1f} ms a frame on the card; the cpu's "
             f"{len(kept)} id-maps in {cpu_s:.2f} s (a thread beside the clustering above, "
             f"{time.perf_counter() - t0:.1f} s of it waited for), "
             f"{1e3 * cpu_s / len(kept):.1f} ms a frame, byte-equal to cuda's; "
             f"{card_seg.last_sweeps} sweeps, {regions} regions kept; largest id {largest}")
        _say(f"[ingest] ingest launches {json.dumps(launches)}; phase 18 in "
             f"{time.perf_counter() - t_phase:.1f} s ({card})")
        return {"launches": launches}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def ingest_reference() -> int:
    """``--ingest-reference``: phase 18's exported scan masked and clustered
    through the CPU route in both configurations; prints each run's objects
    and digests beside INGEST_CPU_DIGESTS and fails if they differ. Needs no
    card."""
    import shutil
    import tempfile

    import torch

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ingest_ref_")
    try:
        root = export_capture(tmp, full_size_scene())[0]
        got = {}
        for label, cfg in ingest_configs(root).items():
            st, wall = _cluster_export(cfg, "cpu", os.path.join(tmp, "pred"))
            got[label] = _pinned(st)
            _say(f"[ingest-reference] {label} on cpu ({torch.get_num_threads()} threads): "
                 f"{json.dumps(got[label])} in {wall:.2f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if got != INGEST_CPU_DIGESTS:
        _say(f"[ingest-reference] differs from INGEST_CPU_DIGESTS {json.dumps(INGEST_CPU_DIGESTS)}")
        return 1
    _say("[ingest-reference] == INGEST_CPU_DIGESTS")
    return 0


# phase 19: the visualisation steps on phase 10's second full-size scan, the
# TASMap variant on the mid-size scan (its masks made by the grid
# segmenter), and the seeded colours each recorded object is checked with
VIS_SCAN = BATCH_SCANS[1]
SPLAT_KERNELS = ("splat_depth", "splat_color", "splat_bbox")
# the kernels of the render entry (project_zbuffer); the top_images step
# launches only splat_bbox
RENDER_KERNELS = ("splat_depth", "splat_color")
SPLAT_COLOR_SEED = 19
# each splat entry's kernels in a profiler trace (their __global__ functions
# in splat.cu; the colour pass's zeroing is a memset)
SPLAT_TRACE = {"splat_depth": ("fill_kernel", "splat_depth_kernel"),
               "splat_color": ("Memset", "splat_color_kernel"),
               "splat_bbox": ("box_init_kernel", "splat_bbox_kernel")}


@contextlib.contextmanager
def recording_boxes(calls):
    """Keep the inputs of every ``bboxes_by_projection`` call on a CUDA
    device (the top_images step's boxes, one call an object):
    ``(points, intrinsics (F, 3, 3), cam_to_world (F, 4, 4), height,
    width)``, the points as the card tensor the step passed."""
    import torch

    from maskclustering_tpu_torch.visualize import top_images

    real = top_images.bboxes_by_projection

    def rec(points, intrinsics, cam_to_world, image_hw, *, device=None):
        out = real(points, intrinsics, cam_to_world, image_hw, device=device)
        if isinstance(points, torch.Tensor) and points.device.type == "cuda":
            calls.append((points, intrinsics, cam_to_world, *image_hw))
        return out

    top_images.bboxes_by_projection = rec
    try:
        yield calls
    finally:
        top_images.bboxes_by_projection = real


def _splat_inputs(dev, call, seed: int):
    """(points, seeded colours in [0, 1), (F, 16) cameras) of a recorded
    object on the card, the cameras made as the step makes them."""
    import numpy as np
    import torch

    from maskclustering_tpu_torch.visualize.top_images import _camera_params

    pts, intr, c2w, _, _ = call
    pts = pts.to(dev).contiguous()
    cols = torch.from_numpy(np.random.default_rng(seed).random(
        (pts.shape[0], 3), dtype=np.float32)).to(dev)
    return pts, cols, _camera_params(intr, c2w, dev)


def _splat_all(pts, cols, prm, h, w):
    """The kernels' and the plain versions' (zbuf, codebuf, visible, box) on
    the card, for (F, 16) cameras or one (16,)."""
    from maskclustering_tpu_torch.ops.cuda import (
        splat_bbox_cuda,
        splat_color_cuda,
        splat_depth_cuda,
    )
    from maskclustering_tpu_torch.visualize import top_images as ti

    zb = splat_depth_cuda(pts, prm, height=h, width=w)
    got = (zb, *splat_color_cuda(pts, cols, prm, zb, height=h, width=w),
           splat_bbox_cuda(pts, prm, height=h, width=w))
    zr = ti.splat_depth_reference(pts, prm, h, w)
    want = (zr, *ti.splat_color_reference(pts, cols, prm, zr, h, w),
            ti.splat_bbox_reference(pts, prm, h, w))
    return got, want


def _splat_differs(pts, cols, prm, h, w) -> list:
    """What the three entries get wrong against their plain versions, over
    the (F, 16) cameras and over each one alone (F = 1)."""
    import torch

    bad = []
    for label, cams in [("batched", prm)] + [(f"frame {k}", prm[k:k + 1])
                                             for k in range(prm.shape[0])]:
        got, want = _splat_all(pts, cols, cams, h, w)
        bad += [f"{label} {what}" for what, g, r in zip(
            ("zbuf", "codebuf", "visible", "box"), got, want) if not torch.equal(g, r)]
    return bad


def check_splat_edges(dev) -> None:
    """The three splat entries bit-equal to their plain versions on the
    card, batched and at F = 1, on every case and batch of
    ``ops/splat_cases.py``; the card's ``project_zbuffer`` (each frame of a
    batch) and ``bbox(es)_by_projection`` equal to the CPU's on each."""
    import torch

    from maskclustering_tpu_torch.ops.splat_cases import SPLAT_BATCHES, SPLAT_CASES
    from maskclustering_tpu_torch.visualize import top_images as ti

    for one, name, c in [*((True, *kv) for kv in SPLAT_CASES.items()),
                         *((False, *kv) for kv in SPLAT_BATCHES.items())]:
        h, w = c["height"], c["width"]
        bad = []
        if not one:  # each batch holds its case's own camera: F = 1 there
            pts = torch.from_numpy(c["points"]).to(dev)
            cols = torch.from_numpy(c["colors"]).to(dev)
            prm = ti._camera_params(c["intrinsics"], c["cam_to_world"], dev)
            bad += _splat_differs(pts, cols, prm, h, w)
        box = ti.bbox_by_projection if one else ti.bboxes_by_projection
        cams = [(c["intrinsics"], c["cam_to_world"])] if one else \
            list(zip(c["intrinsics"], c["cam_to_world"]))
        for intr, c2w in cams:
            args = (c["points"], c["colors"], intr, c2w, h, w)
            card = ti.project_zbuffer(*args, device=dev)
            host = ti.project_zbuffer(*args, device="cpu")
            bad += [what for what, g, r in zip(("image", "zmap", "visible"), card, host)
                    if not torch.equal(g.cpu().view(torch.uint8), r.view(torch.uint8))]
        args = (c["points"], c["intrinsics"], c["cam_to_world"], (h, w))
        if box(*args, device=dev) != box(*args, device="cpu"):
            bad.append("box")
        if bad:
            raise AssertionError(f"splat {'case' if one else 'batch'} {name}: the card "
                                 f"differs in {bad}")
    _say(f"[vis] splat_depth, splat_color and splat_bbox == plain, batched and at F = 1, on the "
         f"{len(SPLAT_CASES)} cases and {len(SPLAT_BATCHES)} batches of ops/splat_cases.py; "
         f"project_zbuffer and bbox(es)_by_projection cuda == cpu on each")


def _plain_box(zbuf, h: int, w: int) -> list:
    """Each frame's box from a depth buffer as JAX takes it: ``isfinite``,
    then ``nonzero``."""
    import torch

    out = []
    for row in zbuf:
        ys, xs = torch.nonzero(torch.isfinite(row[:h * w].view(torch.float32).reshape(h, w)),
                               as_tuple=True)
        out.append(None if ys.numel() == 0 else (int(xs.min()), int(ys.min()),
                                                 int(xs.max()), int(ys.max())))
    return out


def _trace_events(path: str) -> list:
    """[(name, ms)] of the kernels and memsets of a chrome trace, in the
    order they started."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return [(name, ms) for _, name, ms in sorted(
        (float(ev["ts"]), ev["name"], float(ev["dur"]) / 1e3) for ev in events
        if ev.get("cat") in ("kernel", "gpu_memset") and "dur" in ev)]


def _entry_device_ms(events: list, entry: str, calls: int):
    """(kernel ms of each of ``calls`` launches of ``entry``'s main kernel,
    device ms of each of those calls with its fill) from a list of
    :func:`_trace_events`, or None when it holds other counts."""
    fill, main = SPLAT_TRACE[entry]
    kern = [ms for name, ms in events if main in name]
    pre = [ms for name, ms in events if fill in name]
    if len(kern) != calls or len(pre) != calls:
        return None
    return kern, [a + b for a, b in zip(pre, kern)]


# profiled rounds of a window: a trace may lose the first events of a
# window, so only the last round is read
SPLAT_PROFILE_ROUNDS = 3


def profile_splats(objects, tmp: str):
    """Kernel-only device times from two ``torch.profiler`` windows, each of
    SPLAT_PROFILE_ROUNDS rounds of which the last is read: every entry once
    on every recorded object, then the step's old schedule through these
    kernels (a depth and a colour pass a frame at F = 1). Returns ({entry:
    (kernel ms of each object's launch, device ms of each object's call)},
    the F = 1 schedule's device ms over the scan); None where the trace does
    not hold the round whole."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from maskclustering_tpu_torch.ops.cuda import (
        splat_bbox_cuda,
        splat_color_cuda,
        splat_depth_cuda,
    )

    def window(label, fn, per_round):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(SPLAT_PROFILE_ROUNDS):
                fn()
            torch.cuda.synchronize()
        path = os.path.join(tmp, f"splat_{label}.json")
        prof.export_chrome_trace(path)
        events = _trace_events(path)
        return events[-per_round:] if len(events) >= per_round else []

    def new():
        for pts, cols, prm, h, w in objects:
            zb = splat_depth_cuda(pts, prm, height=h, width=w)
            splat_color_cuda(pts, cols, prm, zb, height=h, width=w)
            splat_bbox_cuda(pts, prm, height=h, width=w)

    def single():
        for pts, _, prm, h, w in objects:
            zeros = torch.zeros_like(pts)
            for k in range(prm.shape[0]):
                zb = splat_depth_cuda(pts, prm[k:k + 1], height=h, width=w)
                splat_color_cuda(pts, zeros, prm[k:k + 1], zb, height=h, width=w)

    # a round's device events: each entry's kernel and its fill an object;
    # the F = 1 schedule's zero colours and four events a frame
    events = window("batched", new, 6 * len(objects))
    per = {k: _entry_device_ms(events, k, len(objects)) for k in SPLAT_KERNELS}
    frames = sum(prm.shape[0] for _, _, prm, _, _ in objects)
    f1_events = window("f1", single, len(objects) + 4 * frames)
    whole = sum(1 for name, _ in f1_events if "splat_depth_kernel" in name) == frames
    return per, (sum(ms for _, ms in f1_events) if whole else None)


def check_and_time_splats(dev, calls, tmp: str) -> dict:
    """Phase 19 (c): the three entries bit-equal to their plain versions on
    every recorded object, batched and at F = 1 (the step's zero colours and
    seeded ones), and the box equal to the one JAX takes from the plain
    z-buffer; each entry timed with CUDA events over its wrapper and as
    kernel-only device time from a profiler trace, at the largest object and
    summed over the scan, beside the step's old schedule run through these
    kernels (two F = 1 passes a frame; not the parent's code, whose
    separate fills and host work it leaves out)."""
    import torch

    from maskclustering_tpu_torch.ops.cuda import (
        splat_bbox_cuda,
        splat_bytes,
        splat_color_cuda,
        splat_depth_cuda,
    )
    from maskclustering_tpu_torch.visualize import top_images as ti

    t0 = time.perf_counter()
    objects = []
    for i, call in enumerate(calls):
        pts, cols, prm = _splat_inputs(dev, call, SPLAT_COLOR_SEED + i)
        h, w = call[3], call[4]
        for colours in (torch.zeros_like(cols), cols):
            bad = _splat_differs(pts, colours, prm, h, w)
            if bad:
                raise AssertionError(f"splat object {i} ({pts.shape[0]} points, {prm.shape[0]} "
                                     f"frames, {h}x{w}): the kernels differ from the plain "
                                     f"version in {bad}")
        rows = splat_bbox_cuda(pts, prm, height=h, width=w).cpu().tolist()
        boxes = [None if r[0] > r[2] else tuple(r) for r in rows]
        if boxes != _plain_box(ti.splat_depth_reference(pts, prm, h, w), h, w):
            raise AssertionError(f"splat object {i}: splat_bbox {boxes} is not the box of the "
                                 f"plain z-buffer's finite pixels")
        objects.append((pts, cols, prm, h, w))

    def entries(pts, cols, prm, h, w, zb, zr):
        return {"splat_depth": (lambda: splat_depth_cuda(pts, prm, height=h, width=w),
                                lambda: ti.splat_depth_reference(pts, prm, h, w)),
                "splat_color": (lambda: splat_color_cuda(pts, cols, prm, zb, height=h, width=w),
                                lambda: ti.splat_color_reference(pts, cols, prm, zr, h, w)),
                "splat_bbox": (lambda: splat_bbox_cuda(pts, prm, height=h, width=w),
                               lambda: ti.splat_bbox_reference(pts, prm, h, w))}

    def f1_schedule(pts, prm, h, w):
        zeros = torch.zeros_like(pts)

        def run():
            for k in range(prm.shape[0]):
                zb = splat_depth_cuda(pts, prm[k:k + 1], height=h, width=w)
                splat_color_cuda(pts, zeros, prm[k:k + 1], zb, height=h, width=w)
        return run

    seconds = {"check": time.perf_counter() - t0}
    t0 = time.perf_counter()
    scene_ms = {k: 0.0 for k in SPLAT_KERNELS}
    scene_bytes = {k: 0 for k in SPLAT_KERNELS}
    f1_scene_ms = 0.0
    for pts, cols, prm, h, w in objects:
        zb = splat_depth_cuda(pts, prm, height=h, width=w)
        for k, (kern, _) in entries(pts, cols, prm, h, w, zb, None).items():
            scene_ms[k] += cuda_time_ms(kern, 10)
            scene_bytes[k] += splat_bytes(k, pts.shape[0], prm.shape[0], h, w)
        f1_scene_ms += cuda_time_ms(f1_schedule(pts, prm, h, w), 10)
    big = max(range(len(objects)), key=lambda i: objects[i][0].shape[0])
    pts, cols, prm, h, w = objects[big]
    zb = splat_depth_cuda(pts, prm, height=h, width=w)
    zr = ti.splat_depth_reference(pts, prm, h, w)
    nbytes = {k: splat_bytes(k, pts.shape[0], prm.shape[0], h, w) for k in SPLAT_KERNELS}
    f1_big_ms = cuda_time_ms(f1_schedule(pts, prm, h, w), 50)
    seconds["time"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    device, f1_device = profile_splats(objects, tmp)
    seconds["profile"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = {}
    for k, (kern, plain) in entries(pts, cols, prm, h, w, zb, zr).items():
        traced = device.get(k)
        out[k] = {"ms": cuda_time_ms(kern, 50), "plain_ms": cuda_time_ms(plain, 20),
                  "bytes": nbytes[k], "bound_ms": nbytes[k] / PEAK_HBM_BYTES * 1e3,
                  "bound_by": "bytes", "max_abs_err": 0.0, "scene_ms": scene_ms[k],
                  "scene_bound_ms": scene_bytes[k] / PEAK_HBM_BYTES * 1e3,
                  "kernel_ms": traced[0][big] if traced else None,
                  "device_ms": traced[1][big] if traced else None,
                  "scene_kernel_ms": sum(traced[0]) if traced else None,
                  "scene_device_ms": sum(traced[1]) if traced else None,
                  "shape": (int(pts.shape[0]), int(prm.shape[0]), h, w)}
    seconds["time largest"] = time.perf_counter() - t0
    out["f1_schedule"] = {"ms": f1_big_ms, "scene_ms": f1_scene_ms,
                          "scene_device_ms": f1_device, "frames": int(prm.shape[0]),
                          "seconds": {k: round(v, 2) for k, v in seconds.items()}}
    return out


def render_frames(dev, calls) -> dict:
    """Phase 19 (e): ``project_zbuffer``, the render entry a user calls,
    into each frame of every recorded object with its seeded colours on the
    card, the counts set to 0 just before and read just after; each image,
    depth and visibility equal to the CPU's. Returns the counts: one depth
    and one colour launch a frame."""
    import torch

    from maskclustering_tpu_torch.ops import cuda as kernels
    from maskclustering_tpu_torch.visualize.top_images import project_zbuffer

    inputs = []
    for i, (pts, intr, c2w, h, w) in enumerate(calls):
        cols = _splat_inputs(dev, (pts, intr, c2w, h, w), SPLAT_COLOR_SEED + i)[1]
        inputs += [(pts, cols, intr[k], c2w[k], h, w) for k in range(len(intr))]
    kernels.LAUNCHES.reset()
    card = [project_zbuffer(*args, device=dev) for args in inputs]
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES.counts)
    for i, (args, got) in enumerate(zip(inputs, card)):
        want = project_zbuffer(args[0].cpu(), args[1].cpu(), *args[2:], device="cpu")
        bad = [what for what, g, r in zip(("image", "zmap", "visible"), got, want)
               if not torch.equal(g.cpu().view(torch.uint8), r.view(torch.uint8))]
        if bad:
            raise AssertionError(f"project_zbuffer (object, frame) {i}: cuda and cpu differ "
                                 f"in {bad}")
    for k in RENDER_KERNELS:
        if launches.get(k, 0) != len(inputs):
            raise AssertionError(f"project_zbuffer launched {k} {launches.get(k, 0)} times for "
                                 f"{len(inputs)} (object, frame) pairs")
    return launches


def _tree_files(root: str) -> dict:
    """{relative path: SHA-256} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = _sha(fh.read())
    return out


def _vis_steps(cfg, dev, pred: str):
    """The vis and top_images steps over VIS_SCAN on ``dev``: (report, the
    kernels' launch counts of the run)."""
    from maskclustering_tpu_torch.ops import cuda as kernels
    from maskclustering_tpu_torch.run import run_pipeline

    kernels.LAUNCHES.reset()
    rep = run_pipeline(cfg, [VIS_SCAN], steps=("vis", "top_images"), resume=False,
                       journal=False, prediction_root=pred, device=dev)
    launches = dict(kernels.LAUNCHES.counts)
    if not rep.ok:
        raise AssertionError(f"the vis steps failed on {dev}: {rep.step_errors}")
    return rep, launches


def vis_phase(dev, card: str, batch) -> dict:
    """Phase 19: visualisation and the TASMap variant on the card."""
    import shutil
    import tempfile

    import numpy as np

    from maskclustering_tpu_torch.config import load_config
    from maskclustering_tpu_torch.ops import cuda as kernels
    from maskclustering_tpu_torch.run import TASMAP_STEPS, run_pipeline

    t_phase = time.perf_counter()
    parts, t_part = {}, [t_phase]

    def part(name: str) -> None:
        """Book the seconds since the last part of the phase to ``name``."""
        now = time.perf_counter()
        parts[name] = round(now - t_part[0], 1)
        t_part[0] = now

    check_splat_edges(dev)
    part("cases")
    root, cfg, pred = batch["root"], batch["cfg"], batch["pred"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_vis_")
    try:
        # (a) vis + top_images on the card, every object's box inputs kept
        calls = []
        with recording_boxes(calls):
            rep, launches = _vis_steps(cfg, dev, pred)
        part("steps cuda")
        od = os.path.join(root, "scannet", "processed", VIS_SCAN, "output", "object",
                          cfg.config_name, "object_dict.npy")
        objects = np.load(od, allow_pickle=True).item()
        framed = [o for o in objects.values() if o.get("repre_mask_list")]
        frames = sum(len(o["repre_mask_list"]) for o in framed)
        if len(calls) != len(framed) or frames == 0 \
                or sum(len(c[1]) for c in calls) != frames:
            raise AssertionError(f"{len(calls)} box calls recorded for {len(framed)} objects "
                                 f"with {frames} (object, frame) pairs")
        # one splat_bbox launch and one (F, 4) pull an object; no z-buffer
        if launches.get("splat_bbox", 0) != len(calls) \
                or any(launches.get(k, 0) for k in RENDER_KERNELS):
            raise AssertionError(f"the top_images step launched {json.dumps(launches)} for "
                                 f"{len(calls)} objects")
        _say(f"[vis] vis + top_images on {dev} over {VIS_SCAN}: {len(objects)} objects, {frames} "
             f"(object, frame) boxes in {len(calls)} splat_bbox launches and {len(calls)} pulls, "
             f"steps (s) {json.dumps({k: round(v, 3) for k, v in rep.step_seconds.items()})}; "
             f"launches {json.dumps(launches)}")
        # (b) the same steps on the cpu into a second root (the scans linked)
        root2 = os.path.join(tmp, "cpu_root")
        os.makedirs(root2)
        os.symlink(os.path.join(root, "scannet"), os.path.join(root2, "scannet"))
        rep_cpu, cpu_launches = _vis_steps(cfg.replace(data_root=root2), "cpu", pred)
        if cpu_launches:
            raise AssertionError(f"the cpu run launched kernels: {cpu_launches}")
        card_files = _tree_files(os.path.join(root, "vis", VIS_SCAN))
        cpu_files = _tree_files(os.path.join(root2, "vis", VIS_SCAN))
        if card_files != cpu_files or not card_files:
            raise AssertionError(f"the vis files on {dev} and cpu differ: "
                                 f"{sorted(set(card_files.items()) ^ set(cpu_files.items()))[:6]}")
        part("steps cpu")
        _say(f"[vis] {len(card_files)} files on {dev} == cpu byte for byte; cpu steps (s) "
             f"{json.dumps({k: round(v, 3) for k, v in rep_cpu.step_seconds.items()})}")
        # (c) the three entries against the plain versions on every object,
        # timed; (e) the render entry into every frame, its launches counted
        timed = check_and_time_splats(dev, calls, tmp)
        f1 = timed.pop("f1_schedule")
        fmt = lambda v, d=4: "not measured" if v is None else f"{v:.{d}f} ms"  # noqa: E731
        # the bound counts each entry's fill, so its share is read against
        # the time that does the fill too: the wrapper's or the device's
        share = lambda b, t: "not measured" if not t else f"{100 * b / t:.1f} %"  # noqa: E731
        for k, t in timed.items():
            _say(f"[kernels] {k} == plain on all {len(calls)} objects, batched and at F = 1 (zero "
                 f"and seeded colours); at the largest (N, F, H, W) {t['shape']}: wrapper "
                 f"{t['ms']:.4f} ms (CUDA events), kernel {fmt(t['kernel_ms'])} and with its "
                 f"fill {fmt(t['device_ms'])} (profiler), plain {t['plain_ms']:.4f} ms, bound "
                 f"{t['bound_ms']:.5f} ms ({t['bound_by']}: {t['bytes']} bytes), "
                 f"bound/time {share(t['bound_ms'], t['ms'])} by the wrapper, "
                 f"{share(t['bound_ms'], t['device_ms'])} by the kernel with its fill; "
                 f"summed over the scan: wrapper {t['scene_ms']:.4f} ms, kernel "
                 f"{fmt(t['scene_kernel_ms'])}, with fills {fmt(t['scene_device_ms'])}, bound "
                 f"{t['scene_bound_ms']:.5f} ms, bound/time "
                 f"{share(t['scene_bound_ms'], t['scene_device_ms'])} with fills")
        _say(f"[kernels] the step's old schedule through these kernels (a splat_depth and a "
             f"splat_color launch at F = 1 a frame; not the parent's code): {f1['ms']:.4f} ms "
             f"at the largest object ({f1['frames']} frames), {f1['scene_ms']:.4f} ms summed "
             f"over the scan (CUDA events), {fmt(f1['scene_device_ms'])} of device time "
             f"(profiler); the step now launches splat_bbox alone: "
             f"{timed['splat_bbox']['scene_ms']:.4f} ms summed; (s) {json.dumps(f1['seconds'])}")
        part("objects")
        render_launches = render_frames(dev, calls)
        part("render")
        _say(f"[vis] project_zbuffer into the {frames} (object, frame) pairs on {dev} == cpu; "
             f"launches {json.dumps(render_launches)}")
        # (d) TASMAP_STEPS on the mid-size scan, masks by the grid segmenter,
        # on the card and on the cpu: every file equal
        tas = {}
        for d in (dev, "cpu"):
            r = os.path.join(tmp, f"tasmap_{str(d).split(':')[0]}")
            src = os.path.join(root, "scannet", "processed", MID_SCAN)
            shutil.copytree(src, os.path.join(r, "scannet", "processed", MID_SCAN),
                            ignore=shutil.ignore_patterns("output"))
            tcfg = load_config("scannet", data_root=r, step=1, distance_threshold=0.03,
                               few_points_threshold=10, config_name="chip_smoke_tasmap",
                               cropformer_path="grid")
            kernels.LAUNCHES.reset()
            t0 = time.perf_counter()
            trep = run_pipeline(tcfg, [MID_SCAN], steps=TASMAP_STEPS, resume=False,
                                journal=False, device=d)
            wall = time.perf_counter() - t0
            got = dict(kernels.LAUNCHES.counts)
            if not trep.ok or trep.scenes[0].num_objects == 0:
                raise AssertionError(f"TASMAP_STEPS on {d}: {trep.step_errors} "
                                     f"{[(s.status, s.error[-300:]) for s in trep.scenes]}")
            tas[str(d)] = (_tree_files(r), got, trep)
            _say(f"[vis] TASMAP_STEPS on {d} over {MID_SCAN} (masks by 'grid'): "
                 f"{trep.scenes[0].num_objects} objects, digest "
                 f"{trep.scenes[0].digest['artifact']}, steps (s) "
                 f"{json.dumps({k: round(v, 3) for k, v in trep.step_seconds.items()})}, run "
                 f"{wall:.2f} s; launches {json.dumps(got)}")
        (f_card, tasmap_launches, _), (f_cpu, _, _) = tas[str(dev)], tas["cpu"]
        if f_card != f_cpu:
            raise AssertionError(f"TASMAP_STEPS files differ between {dev} and cpu: "
                                 f"{sorted(set(f_card.items()) ^ set(f_cpu.items()))[:6]}")
        for k in ASSOCIATION_KERNELS + ("splat_bbox",):
            if not tasmap_launches.get(k):
                raise AssertionError(f"TASMAP_STEPS on {dev} launched no {k}")
        if any(tasmap_launches.get(k, 0) for k in RENDER_KERNELS):
            raise AssertionError(f"TASMAP_STEPS on {dev} rendered z-buffers: {tasmap_launches}")
        part("tasmap")
        _say(f"[vis] TASMAP_STEPS: {len(f_card)} files on {dev} == cpu byte for byte (id-maps, "
             f"npz, object dict, PLYs, bbox and grid PNGs); phase 19 in "
             f"{time.perf_counter() - t_phase:.1f} s ({card}), parts (s) {json.dumps(parts)}")
        return {"launches": launches, "render_launches": render_launches, "timed": timed,
                "tasmap_launches": tasmap_launches}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def static_checks_phase(dev, card: str, batch) -> None:
    """Phase 20: the port's static checks on the card's machine (which has
    no jax), and one full-size scan through the batch CLI under the lock
    sanitizer, its observed lock graph embedded in the static one."""
    import shutil
    import tempfile

    from maskclustering_tpu_torch.analysis.concurrency import build_lock_order_graph
    from maskclustering_tpu_torch.analysis.lock_sanitizer import check_embeds

    here = os.path.dirname(os.path.abspath(__file__))
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_static_")
    try:
        cfg = batch["cfg"]
        conf = os.path.join(tmp, "chip_smoke_locks.json")
        with open(os.path.join(here, "configs", "scannet.json")) as fh:
            doc = json.load(fh)
        doc.update(step=1, distance_threshold=0.01, post_neighbor_cap=cfg.post_neighbor_cap)
        with open(conf, "w") as fh:
            json.dump(doc, fh)
        report = os.path.join(tmp, "locks_run.json")
        cli = ["--config", conf, "--data_root", batch["root"], "--seq_name_list",
               BATCH_SCANS[2], "--steps", "cluster", "--no-resume", "--no-journal",
               "--lock-sanitizer", "--report", report, "--ledger",
               os.path.join(tmp, "ledger.jsonl")]
        t0 = time.perf_counter()
        (a_rc, a_out, a_err), (r_rc, _, r_err) = _run_modules(here, [
            ("maskclustering_tpu_torch.analysis", ["--format", "json"]),
            ("maskclustering_tpu_torch.run", cli)])
        wall = time.perf_counter() - t0
        if a_rc != 0:
            raise AssertionError(f"python -m maskclustering_tpu_torch.analysis exited {a_rc}:\n"
                                 f"{a_out[-2000:]}\n{a_err[-2000:]}")
        res = json.loads(a_out)
        if r_rc != 0:
            raise AssertionError(f"the --lock-sanitizer run exited {r_rc}:\n{r_err[-3000:]}")
        from maskclustering_tpu_torch.obs.report import RunData

        counters = RunData(os.path.splitext(report)[0] + "_events.jsonl")._counters
        locks = {k: v for k, v in counters.items() if k.startswith("locks.")}
        if set(locks) != {"locks.acquisitions", "locks.order_edges", "locks.long_holds"} \
                or not locks["locks.acquisitions"]:
            raise AssertionError(f"the run's locks.* counters: {locks}")
        with open(os.path.splitext(report)[0] + "_locks.json") as fh:
            observed_doc = json.load(fh)
        observed = {tuple(e.split(" -> ")) for e in observed_doc["order_edges"]}
        nodes, edges = build_lock_order_graph(here)
        violations = check_embeds(observed, edges, nodes)
        if violations:
            raise AssertionError("\n".join(violations))
        _say(f"[static] python -m maskclustering_tpu_torch.analysis: exit 0, "
             f"{len(res['findings'])} finding(s), {len(res['suppressed'])} suppressed by the "
             f"port's baseline, {len(res['stale'])} stale, {res['elapsed_s']} s; the lock graph: "
             f"{len(nodes)} named locks, {len(edges)} static order edge(s)")
        _say(f"[static] run --lock-sanitizer over {BATCH_SCANS[2]}: {json.dumps(locks)}; "
             f"{len(observed)} observed order edge(s), all in the static graph; "
             f"{len(observed_doc['acquisitions'])} named locks taken, the longest holds (s) "
             f"{json.dumps(dict(sorted(observed_doc['max_hold_s'].items(), key=lambda kv: -kv[1])[:3]))}; "
             f"both processes at once in {wall:.1f} s; phase 20 in "
             f"{time.perf_counter() - t_phase:.1f} s ({card})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# phase 21: the entry names of the association kernels in a profiler
# trace (their __global__ functions in associate.cu), and a synthetic
# request at a bucket no earlier phase dispatched (another image size)
TRACE_KERNELS = {"associate_table": "table_kernel", "associate_claim": "claim_scene_kernel",
                 "associate_assign": "assign_scene_kernel"}
TOOLING_COLD_SPEC = {"num_boxes": 2, "num_frames": 8, "image_hw": [120, 160], "seed": 5}


def _aot_child(here, conf, root, cache, label, tmp):
    """One ``python -m maskclustering_tpu_torch.run --aot-cache`` over phase
    10's first scan: (its aot stats, its nvcc builds, its digest)."""
    report = os.path.join(tmp, f"aot_{label}.json")
    rc, _, err = _run_module(here, "maskclustering_tpu_torch.run", [
        "--config", conf, "--data_root", root, "--seq_name_list", BATCH_SCANS[0], "--steps",
        "cluster", "--no-resume", "--no-journal", "--no-obs", "--report", report,
        "--ledger", os.path.join(tmp, "ledger.jsonl"), "--aot-cache", cache])
    if rc != 0:
        raise AssertionError(f"aot child {label} exited {rc}:\n{err[-3000:]}")
    mark = "; nvcc builds in this process: "
    line = next(ln for ln in err.splitlines() if mark in ln)
    stats, builds = line.split("aot cache: ", 1)[1].split(mark)
    with open(report) as fh:
        digest = json.load(fh)["scenes"][0]["digest"]["artifact"]
    return json.loads(stats), json.loads(builds), digest


def _trace_kernels(path: str) -> dict:
    """The association kernels' CUDA events in a Chrome trace, and whether
    each lies inside an ``associate`` range: {entry: (count, inside, us)}."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    ranges = [(ev["ts"], ev["ts"] + ev.get("dur", 0)) for ev in events
              if ev.get("name") == "associate" and ev.get("ph") == "X"]
    out = {}
    for entry, fn in TRACE_KERNELS.items():
        evs = [ev for ev in events if ev.get("cat") == "kernel" and fn in ev.get("name", "")]
        inside = sum(1 for ev in evs if any(a <= ev["ts"] and ev["ts"] + ev.get("dur", 0) <= b
                                            for a, b in ranges))
        out[entry] = (len(evs), inside, sum(ev.get("dur", 0) for ev in evs))
    return out


def tooling_phase(dev, card: str, tensors, dense, batch) -> dict:
    """Phase 21: the tooling on the card: the cost observatory, the kernel
    build cache across processes, the analyzer, the profiler captures, the
    host-sync guard and the build/launch-surface sanitizer."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from maskclustering_tpu_torch.analysis import retrace_sanitizer, transfer_guard
    from maskclustering_tpu_torch.models import pipeline, run_scene
    from maskclustering_tpu_torch.obs import cost
    from maskclustering_tpu_torch.obs.report import render_cost
    from maskclustering_tpu_torch.ops import cuda as kernels
    from maskclustering_tpu_torch.run import run_pipeline
    from maskclustering_tpu_torch.serve import ServeClient
    from maskclustering_tpu_torch.serve.daemon import ServeDaemon
    from maskclustering_tpu_torch.utils import aot_cache
    from maskclustering_tpu_torch.utils.compile_cache import scene_pads
    from maskclustering_tpu_torch.utils.synthetic import make_scene, to_scene_tensors

    here = os.path.dirname(os.path.abspath(__file__))
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tooling_", dir="/tmp")
    root, bcfg = batch["root"], batch["cfg"]
    want = {scene: dg["artifact"] for scene, (dg, _) in batch["scans"].items()}
    try:
        # (c) first, nothing beside it: the observatory's five stages on
        # phase 8's scene padded as the fused step takes it, each timed
        cfg = dense["cfg"]
        f_pad, n_pad = scene_pads(cfg, tensors.num_frames, tensors.num_points)
        t = pipeline.pad_scene_tensors(tensors, f_pad, n_pad)
        h, w = t.depths.shape[1:]
        arrays = tuple(np.asarray(a)[None] for a in (
            t.scene_points, t.depths, t.segmentations, t.intrinsics, t.cam_to_world,
            t.frame_valid))
        t0 = time.perf_counter()
        rows = cost.observe_costs([(1, 1)], frames=f_pad, points=n_pad, image_hw=(h, w),
                                  k_max=63, cfg=cfg, device=dev, batch=arrays,
                                  time_stages=True)
        cost_s = time.perf_counter() - t0
        bad = [r for r in rows if "error" in r]
        if bad or len(rows) != 5:
            raise AssertionError(f"cost observatory rows: {bad or len(rows)}")
        bound_bytes = {k: v["bytes"] for k, v in dense["timed"].items()}
        for r in rows:
            if r["stage"] in ("backprojection", "fused"):
                got = {k: v["bytes"] for k, v in r["kernels"].items()}
                if got != {k: float(v) for k, v in bound_bytes.items()}:
                    raise AssertionError(f"{r['stage']}: kernel bytes {got}, the bound's "
                                         f"{bound_bytes}")
        _say(f"[tooling] cost observatory on {card}, phase 8's scene (F_pad={f_pad} "
             f"N_pad={n_pad} {h}x{w} k_max 63, dense slots M_pad={f_pad * 63}), census and "
             f"timing in {cost_s:.1f} s:\n" + render_cost(rows))
        _say("[tooling] association kernel bytes in the census == phase 8's bound bytes: "
             + json.dumps(bound_bytes))
        for r in rows:
            _say(f"[tooling] {r['stage']}: {r['device_ms']:.4f} ms on the card, bound "
                 f"{r['bound_ms']:.5f} ms ({r['bound_by']}: {r['flops']:.0f} FLOPs, "
                 f"{r['hbm_bytes']:.0f} bytes), {100 * r['roofline_share']:.2f} % of it; "
                 f"{r['ops']['aten']} aten ops, {r['counting_products']} counting products, "
                 f"peak {r['peak_bytes'] / 2**20:.1f} MiB")

        # (d) and (f) beside the rest: the build cache across three child
        # processes, and the analyzer's ir and retrace families
        knobs = {k: v for k, v in dataclasses.asdict(bcfg).items()
                 if k not in ("config_name", "data_root")}
        confs = {}
        for label in ("chip_smoke_aot", "chip_smoke_aot_stamp"):
            confs[label] = os.path.join(tmp, f"{label}.json")
            with open(confs[label], "w") as fh:
                json.dump(knobs, fh)
        cache_a, cache_b = os.path.join(tmp, "aot_a"), os.path.join(tmp, "aot_b")

        def build_cache_drill():
            out = {"cold": _aot_child(here, confs["chip_smoke_aot"], root, cache_a, "cold", tmp)}
            # another toolchain's cache: every entry's stamp changed, its
            # file named for that stamp
            shutil.copytree(cache_a, cache_b)
            with open(os.path.join(cache_b, aot_cache.INDEX_NAME)) as fh:
                doc = json.load(fh)
            stale = {}
            for i, (fname, entry) in enumerate(sorted(doc["entries"].items())):
                new = f"libmc_{entry['kernel']}-stale{i}.so"
                os.rename(os.path.join(cache_b, fname), os.path.join(cache_b, new))
                stale[new] = dict(entry, stamp=dict(entry["stamp"], torch="0.0-other"))
            doc["entries"] = stale
            with open(os.path.join(cache_b, aot_cache.INDEX_NAME), "w") as fh:
                json.dump(doc, fh)
            with ThreadPoolExecutor(2) as ex:
                warm = ex.submit(_aot_child, here, confs["chip_smoke_aot"], root, cache_a,
                                 "warm", tmp)
                changed = ex.submit(_aot_child, here, confs["chip_smoke_aot_stamp"], root,
                                    cache_b, "stamp", tmp)
                out["warm"], out["stamp"] = warm.result(900), changed.result(900)
            out["stale"] = sorted(stale)
            return out

        bg = ThreadPoolExecutor(2)
        drill_f = bg.submit(build_cache_drill)
        analyzer_f = bg.submit(_run_module, here, "maskclustering_tpu_torch.analysis",
                               ["--families", "ir,retrace", "--format", "json"])

        # (a) the profiler: a --profile_dir run of one full-size scan, then
        # --xprof associate over phase 10's three scans
        prof = os.path.join(tmp, "profile")
        t0 = time.perf_counter()
        rep = run_pipeline(bcfg.replace(config_name="chip_smoke_profile"), BATCH_SCANS[:1],
                           steps=("cluster",), resume=False, journal=False, ledger=False,
                           prediction_root=os.path.join(tmp, "pred_profile"),
                           obs_events=os.path.join(tmp, "profile_events.jsonl"), device=dev,
                           profile_dir=prof)
        prof_s = time.perf_counter() - t0
        trace = os.path.join(prof, "trace.json")
        if not rep.ok or rep.scenes[0].digest["artifact"] != want[BATCH_SCANS[0]]:
            raise AssertionError(f"the profiled run: {rep.step_errors} {rep.scenes}")
        found = _trace_kernels(trace)
        if any(n != 1 or inside != 1 for n, inside, _ in found.values()):
            raise AssertionError(f"the trace's association kernels (count, inside the "
                                 f"associate range, us): {found}")
        _say(f"[tooling] --profile_dir over {BATCH_SCANS[0]}: {prof_s:.2f} s with the "
             f"profiler, trace {os.path.getsize(trace)} bytes; the association kernels as "
             f"CUDA kernel events, each inside the 'associate' range: "
             + json.dumps({k: f"{TRACE_KERNELS[k]} {us} us" for k, (_, _, us) in found.items()}))
        xp_events = os.path.join(tmp, "xprof_events.jsonl")
        t0 = time.perf_counter()
        rep = run_pipeline(bcfg.replace(config_name="chip_smoke_xprof"), BATCH_SCANS,
                           steps=("cluster",), resume=False, journal=False, ledger=False,
                           prediction_root=os.path.join(tmp, "pred_xprof"),
                           obs_events=xp_events, device=dev, xprof_spans=("associate",))
        xp_dir = os.path.splitext(xp_events)[0] + "_xprof"
        traces = sorted(os.listdir(xp_dir))
        if not rep.ok or traces != ["associate-0"]:
            raise AssertionError(f"--xprof associate over 3 scans wrote {traces}")
        xp_trace = os.path.join(xp_dir, "associate-0", "trace.json")
        xfound = _trace_kernels(xp_trace)
        if any(n != 1 for n, _, _ in xfound.values()):
            raise AssertionError(f"the xprof trace's association kernels: {xfound}")
        _say(f"[tooling] --xprof associate over {len(BATCH_SCANS)} scans: one trace "
             f"({os.path.getsize(xp_trace)} bytes, one launch of each association kernel) "
             f"in {time.perf_counter() - t0:.2f} s")

        # (b) the guard: phase 8's scene guarded, then a sequential scan
        # under CUDA's own sync check, then an injected read
        transfer_guard.arm(True)
        try:
            t0 = time.perf_counter()
            res = run_scene(tensors, cfg, k_max=63, seq_name="chip_smoke_guard", device=dev)
            guard_s = time.perf_counter() - t0
            pulls = transfer_guard.scene_pulls()
            if res.digest["artifact"] != dense["digest"]:
                raise AssertionError(f"guarded digest {res.digest} != phase 8's {dense['digest']}")
            transfer_guard.arm_cuda_sync_check(True)
            try:
                srep = run_pipeline(bcfg.replace(config_name="chip_smoke_guard_seq",
                                                 scene_overlap=False), BATCH_SCANS[:1],
                                    steps=("cluster",), resume=False, journal=False,
                                    ledger=False, device=dev,
                                    prediction_root=os.path.join(tmp, "pred_guard"))
            finally:
                transfer_guard.arm_cuda_sync_check(False)
            seq_pulls = transfer_guard.scene_pulls()
            if not srep.ok or srep.scenes[0].digest["artifact"] != want[BATCH_SCANS[0]]:
                raise AssertionError(f"the guarded sequential scan: {srep.scenes}")
            small = to_scene_tensors(make_scene(num_boxes=2, num_frames=4, image_hw=(64, 80),
                                                seed=3, spacing=0.08))
            real = pipeline.compute_graph_stats

            def injected(mask_of_point, *a, **kw):
                mask_of_point.sum().item()
                return real(mask_of_point, *a, **kw)

            pipeline.compute_graph_stats = injected
            try:
                pipeline.run_scene_device(small, cfg, device=dev)
            except transfer_guard.HostSyncError as e:
                raised = str(e).split(" outside")[0]
            else:
                raise AssertionError("an injected .item() in the guarded phase did not raise")
            finally:
                pipeline.compute_graph_stats = real
        finally:
            transfer_guard.arm(None)
        _say(f"[tooling] guard: phase 8's scene guarded {guard_s:.2f} s, digest "
             f"{res.digest['artifact']} == phase 8's; sanctioned pulls by name "
             f"{json.dumps(pulls)} ({sum(pulls.values())} in all; JAX makes 1)")
        _say(f"[tooling] guard + set_sync_debug_mode('error') over a sequential scan of "
             f"{BATCH_SCANS[0]}: ok, digest == phase 10's, pulls {json.dumps(seq_pulls)}; an "
             f"injected .item() raised HostSyncError ({raised})")

        # (e) the sanitizer: a daemon warm on phase 15's scan, frozen
        retrace_sanitizer.reset()
        retrace_sanitizer.arm(True)
        retrace_sanitizer.install()
        sock = os.path.join(tempfile.mkdtemp(prefix="mc21", dir="/tmp"), "s.sock")
        d = ServeDaemon(bcfg, socket_path=sock, capacity=2, device=dev,
                        warm_scenes=(BATCH_SCANS[0],))
        try:
            d.start()
            warm = retrace_sanitizer.digest()
            keys = retrace_sanitizer.snapshot_keys()
            with ServeClient(sock, timeout_s=300.0) as c:
                for scene in BATCH_SCANS[1:]:
                    term, _, _ = c.run_scene(scene)
                    if term.get("status") != "ok" or term["digest"]["artifact"] != want[scene]:
                        raise AssertionError(f"sanitized daemon: {scene} answered {term}")
                frozen = c.stats()["retrace"]
                if (retrace_sanitizer.snapshot_keys() != keys or frozen["post_freeze"]
                        or frozen["compiles"] or not frozen["frozen"]):
                    raise AssertionError(f"warm frozen daemon: {frozen}")
                term, _, _ = c.run_scene("chip_smoke_tooling_cold", synthetic=TOOLING_COLD_SPEC)
                after = c.stats()["retrace"]
            if term.get("status") != "ok" or after["post_freeze"] < 1:
                raise AssertionError(f"a new bucket after the freeze: {term} {after}")
            viol = retrace_sanitizer.violations()
        finally:
            d.request_stop()
            d.shutdown()
            shutil.rmtree(os.path.dirname(sock), ignore_errors=True)
            retrace_sanitizer.uninstall()
            retrace_sanitizer.arm(None)
        _say(f"[tooling] sanitizer: a daemon warm on {BATCH_SCANS[0]} and frozen ({warm['distinct_keys']} "
             f"launch keys, {warm['compiles']} builds); {len(BATCH_SCANS) - 1} scans served with "
             f"0 builds and 0 new keys ({json.dumps(frozen)}); a request in a new bucket "
             f"{TOOLING_COLD_SPEC['image_hw']} after the freeze: {after['post_freeze']} "
             f"violation(s) ({sorted({v['fn'] for v in viol})})")
        retrace_sanitizer.reset()

        # (d) and (f) done
        drill = drill_f.result(900)
        a_rc, a_out, a_err = analyzer_f.result(900)
        bg.shutdown()
        cold, warm_run, stamped = drill["cold"], drill["warm"], drill["stamp"]
        libs = sorted(kernels.KERNELS)
        n_libs = len(libs)
        if (cold[0] != {"restored": 0, "built": n_libs, "invalidated": 0} or cold[1] != libs
                or warm_run[0] != {"restored": n_libs, "built": 0, "invalidated": 0}
                or warm_run[1] != [] or warm_run[2] != cold[2]
                or stamped[0] != {"restored": 0, "built": n_libs, "invalidated": n_libs}
                or stamped[1] != libs or stamped[2] != cold[2]
                or cold[2] != want[BATCH_SCANS[0]]):
            raise AssertionError(f"build cache drill: {drill}")
        removed = aot_cache.AotCache(cache_b).prune()
        left = sorted(f for f in os.listdir(cache_b) if f.endswith(".so"))
        if sorted(removed) != drill["stale"] or len(left) != n_libs or set(left) & set(removed):
            raise AssertionError(f"prune removed {removed}, left {left}")
        _say(f"[tooling] build cache: a cold child built {cold[1]} "
             f"({json.dumps(cold[0])}), a second child restored all ({json.dumps(warm_run[0])}, "
             f"nvcc builds {warm_run[1]}), digest {warm_run[2]} == the cold child's == phase "
             f"10's; a changed stamp: {json.dumps(stamped[0])}, rebuilt {stamped[1]}; prune "
             f"removed the {len(removed)} stale files")
        if a_rc != 0:
            raise AssertionError(f"analyzer --families ir,retrace exited {a_rc}:\n{a_out[-3000:]}"
                                 f"\n{a_err[-3000:]}")
        res_a = json.loads(a_out)
        _say(f"[tooling] python -m maskclustering_tpu_torch.analysis --families ir,retrace on "
             f"the card: exit 0, {len(res_a['findings'])} finding(s), "
             f"{len(res_a['suppressed'])} suppressed by the port's baseline "
             f"({[f['id'] for f in res_a['suppressed']]}), {res_a['elapsed_s']} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _say(f"[tooling] phase 21 in {time.perf_counter() - t_phase:.1f} s ({card})")
    return {"cost": rows, "pulls": pulls}


DEMO_SEQ = "demo0001_00"
# the demo's files compared field for field, and their fields that hold a
# wall time or the writing process, never a result: the report's step
# seconds and each scene's seconds and stage walls (``timings``), the
# journal's stamp, pid and seconds. Every other file is compared byte for byte.
DEMO_TIME_FIELDS = {"report.json": ("step_seconds", "seconds", "timings"),
                    "run_journal.jsonl": ("ts", "pid", "seconds")}
# the CPU demo's intra-op threads: it runs beside phases 18-21, so it
# leaves them most of the host's cores
DEMO_CPU_THREADS = 2


def start_demo_cpu() -> dict:
    """Start ``python -m maskclustering_tpu_torch.demo --device cpu`` at the
    JAX demo's default size as a child process; phase 22 joins it."""
    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_demo_")
    root = os.path.join(tmp, "cpu")
    log = os.path.join(tmp, "cpu.log")
    env = dict(os.environ, OMP_NUM_THREADS=str(DEMO_CPU_THREADS))
    t0 = time.perf_counter()
    with open(log, "w") as fh:
        proc = subprocess.Popen([sys.executable, "-m", "maskclustering_tpu_torch.demo",
                                 "--device", "cpu", "--out", root], cwd=here, env=env,
                                stdout=fh, stderr=subprocess.STDOUT, text=True)
    return {"proc": proc, "t0": t0, "tmp": tmp, "root": root, "log": log}


def _demo_fields(path: str, keys) -> object:
    """A JSON or JSON-lines file with the fields ``keys`` dropped at every depth."""
    def drop(obj):
        if isinstance(obj, dict):
            return {k: drop(v) for k, v in obj.items() if k not in keys}
        if isinstance(obj, list):
            return [drop(v) for v in obj]
        return obj

    with open(path) as fh:
        if path.endswith(".jsonl"):
            return [drop(json.loads(line)) for line in fh if line.strip()]
        return drop(json.load(fh))


def demo_differences(root_a: str, root_b: str) -> list:
    """The relative paths whose files differ between two demo roots: every
    file byte for byte, the DEMO_TIME_FIELDS files field for field."""
    a, b = _tree_files(root_a), _tree_files(root_b)
    bad = sorted(set(a) ^ set(b))
    for rel in sorted(set(a) & set(b)):
        keys = DEMO_TIME_FIELDS.get(os.path.basename(rel))
        if keys is None:
            same = a[rel] == b[rel]
        else:
            same = _demo_fields(os.path.join(root_a, rel), keys) == _demo_fields(
                os.path.join(root_b, rel), keys)
        if not same:
            bad.append(rel)
    return bad


def demo_phase(dev, card: str, cpu: dict) -> dict:
    """Phase 22: the zero-download demo on the card against the CPU child
    started after phase 17, file for file."""
    import io
    import re
    import shutil

    from maskclustering_tpu_torch import demo
    from maskclustering_tpu_torch.ops import cuda as kernels

    t_phase = time.perf_counter()
    root = os.path.join(cpu["tmp"], "cuda")
    try:
        out = io.StringIO()
        kernels.LAUNCHES.reset()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = demo.main(["--out", root, "--device", str(dev)])
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES.counts)
        text = out.getvalue()
        if rc != 0 or "MISSING" in text or "FAILED" in text:
            raise AssertionError(f"the demo on {dev} exited {rc}:\n{text[-3000:]}")
        for k in ASSOCIATION_KERNELS + ("splat_bbox",):
            if not launches.get(k):
                raise AssertionError(f"the demo on {dev} launched no {k}: {launches}")
        t_wait = time.perf_counter()
        cpu["proc"].wait(timeout=900)
        waited = time.perf_counter() - t_wait
        with open(cpu["log"]) as fh:
            cpu_text = fh.read()
        if cpu["proc"].returncode != 0:
            raise AssertionError(f"the demo on cpu exited {cpu['proc'].returncode}:\n"
                                 f"{cpu_text[-3000:]}")
        strip = lambda t, r: [ln.replace(r, "<out>") for ln in t.splitlines()  # noqa: E731
                              if ln.startswith("[demo]") and " step " not in ln
                              and "pipeline finished" not in ln]
        if strip(text, root) != strip(cpu_text, cpu["root"]):
            raise AssertionError(f"the demo's lines differ between {dev} and cpu:\n{text}\n"
                                 f"{cpu_text}")
        bad = demo_differences(root, cpu["root"])
        files = _tree_files(root)
        pngs = [r for r in files if r.endswith(".png") and r.startswith("vis")]
        listed = [r for r in demo.artifacts(DEMO_SEQ) if not r.endswith("grid")]
        if bad or not pngs or any(os.path.normpath(r) not in files for r in listed):
            raise AssertionError(f"the demo's files differ between {dev} and cpu: {bad[:8]} "
                                 f"({len(files)} files, {len(pngs)} PNGs under vis)")
        steps = {}
        for d, r in ((str(dev), root), ("cpu", cpu["root"])):
            with open(os.path.join(r, "report.json")) as fh:
                steps[d] = {k: round(v, 3) for k, v in json.load(fh)["step_seconds"].items()}
        for ln in text.splitlines():
            if ln.startswith("[demo]") and ("objects recovered" in ln or "," in ln):
                _say(ln)
        cpu_s = re.search(r"pipeline finished in ([0-9.]+)s", cpu_text).group(1)
        _say(f"[demo] {card}: the demo (32 frames, 6 objects, 240x320, nine steps) on {dev} in "
             f"{wall:.2f} s; on cpu, a child started after phase 17 with {DEMO_CPU_THREADS} "
             f"threads, its pipeline {cpu_s} s by its own clock (waited {waited:.1f} s for it "
             f"here); "
             f"{len(files)} files equal ({len(pngs)} PNGs under vis/, both evaluation files, "
             f"the npz, object dict and PLY byte for byte; report.json and run_journal.jsonl "
             f"field for field but {json.dumps(DEMO_TIME_FIELDS)}); launches on {dev} "
             f"{json.dumps(launches)}")
        _say(f"[demo] step seconds: {json.dumps(steps)}; phase 22 in "
             f"{time.perf_counter() - t_phase:.1f} s")
        return {"launches": launches, "wall": wall, "steps": steps}
    finally:
        shutil.rmtree(cpu["tmp"], ignore_errors=True)


# phase 23: the scan whose colour frames become arithmetic transcodes
KINDS_SCAN = "scene2300_00"


def jpeg_kinds(out_path: str) -> int:
    """``--jpeg-kinds OUT``: every fixture of ``tests/jpeg_writers.py``
    through ``read_rgb``, ``read_rgb_pil`` and ``decode_rgb`` against the
    goldens recorded from cv2 and PIL, each decode timed (best of 3); the
    times go to OUT as JSON. Raises at the first difference."""
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "tests"))
    import jpeg_writers

    with open(jpeg_writers.GOLDENS) as fh:
        goldens = json.load(fh)
    t0 = time.perf_counter()
    ms = jpeg_writers.port_against_goldens(goldens, reps=3)
    with open(out_path, "w") as fh:
        json.dump({"ms": ms, "seconds": time.perf_counter() - t0}, fh)
    return 0


def start_jpeg_kinds_cpu() -> dict:
    """Start ``python chip_smoke.py --jpeg-kinds OUT`` as a child process
    on one thread; phase 23 joins it."""
    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_kinds_")
    out, log = os.path.join(tmp, "kinds.json"), os.path.join(tmp, "kinds.log")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    with open(log, "w") as fh:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--jpeg-kinds", out],
                                cwd=here, env=env, stdout=fh, stderr=subprocess.STDOUT,
                                text=True)
    return {"proc": proc, "t0": t0, "tmp": tmp, "out": out, "log": log}


def jpeg_kinds_phase(dev, card: str, child: dict) -> dict:
    """Phase 23: the JPEG kinds. The child's check of every fixture against
    the goldens, then the features step on the card over a scan's
    arithmetic-coded frames against the step over its Huffman frames."""
    import shutil

    import numpy as np

    from maskclustering_tpu_torch.config import load_config
    from maskclustering_tpu_torch.io import jpeg
    from maskclustering_tpu_torch.run import run_pipeline
    from maskclustering_tpu_torch.utils.synthetic import make_scene, write_scannet_layout

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import jpeg_writers

    t_phase = time.perf_counter()
    try:
        child["proc"].wait(timeout=600)
        with open(child["log"]) as fh:
            text = fh.read()
        if child["proc"].returncode != 0:
            raise AssertionError(f"the JPEG kinds' check exited {child['proc'].returncode}:\n"
                                 f"{text[-3000:]}")
        with open(child["out"]) as fh:
            result = json.load(fh)
        ms = result["ms"]
        refused = sorted(k for k, v in ms.items() if "refused" in v.values())
        read = {k: v for k, v in ms.items() if k not in refused}
        _say(f"[kinds] {len(ms)} fixtures equal to their cv2 and PIL goldens on read_rgb, "
             f"read_rgb_pil and decode_rgb (bytes and pixels), {len(refused)} refused where "
             f"the golden's library refuses ({', '.join(refused)}); the check's child took "
             f"{result['seconds']:.1f} s beside phases 18-22")
        _say(f"[kinds] {card}: host decode ms a frame (best of 3, a CPU child beside the card's "
             f"phases), read_rgb / read_rgb_pil / decode_rgb: " + json.dumps(
                 {k: [round(x, 2) if isinstance(x, float) else x for x in v.values()]
                  for k, v in read.items()}))

        # the features step over the same scan, Huffman then arithmetic frames
        root = os.path.join(child["tmp"], "data")
        write_scannet_layout(make_scene(num_boxes=3, num_frames=8, image_hw=(120, 160),
                                        seed=2300), root, KINDS_SCAN)
        cfg = load_config("scannet").replace(config_name="kinds_huffman", data_root=root,
                                             step=1, distance_threshold=0.03,
                                             mask_pad_multiple=64)
        arith_cfg = cfg.replace(config_name="kinds_arithmetic")

        def features(run_cfg, steps):
            t0 = time.perf_counter()
            rep = run_pipeline(run_cfg, [KINDS_SCAN], steps=steps, resume=False, journal=False,
                               encoder_spec="hash:64", device=dev)
            if not rep.ok:
                raise AssertionError(f"phase 23's {steps} failed: {rep.step_errors}")
            obj = os.path.join(root, "scannet", "processed", KINDS_SCAN, "output", "object",
                               run_cfg.config_name)
            return (np.load(os.path.join(obj, "open-vocabulary_features.npy"),
                            allow_pickle=True).item(), time.perf_counter() - t0,
                    rep.step_seconds)

        huff, huff_s, huff_steps = features(cfg, ("cluster", "features"))
        color = os.path.join(root, "scannet", "processed", KINDS_SCAN, "color")
        t0 = time.perf_counter()
        names = sorted(os.listdir(color))
        for n, fname in enumerate(names):
            path = os.path.join(color, fname)
            with open(path, "rb") as fh:
                data = fh.read()
            arith = jpeg_writers.transcode_arith(data, progressive=bool(n % 2),
                                                 restart=2 * (n % 3))
            if not jpeg._parse(arith, fname).arithmetic:
                raise AssertionError(f"{fname} was not transcoded")
            with open(path, "wb") as fh:
                fh.write(arith)
        transcode_s = time.perf_counter() - t0
        obj = os.path.join(root, "scannet", "processed", KINDS_SCAN, "output", "object")
        os.makedirs(os.path.join(obj, arith_cfg.config_name), exist_ok=True)
        shutil.copy(os.path.join(obj, cfg.config_name, "object_dict.npy"),
                    os.path.join(obj, arith_cfg.config_name, "object_dict.npy"))
        arith, arith_s, arith_steps = features(arith_cfg, ("features",))
        if not huff or list(huff) != list(arith) or not all(
                huff[k].dtype == arith[k].dtype and np.array_equal(huff[k], arith[k])
                for k in huff):
            raise AssertionError("the features over the arithmetic-coded frames differ from "
                                 "those over the Huffman frames")
        _say(f"[kinds] features (hash:64) on {dev} over {KINDS_SCAN} (8 frames at 120x160, 3 "
             f"objects): {len(huff)} vectors over the arithmetic transcodes (sequential and "
             f"progressive, restarts every 0, 2 or 4 MCUs; written in {transcode_s:.2f} s) "
             f"equal to those over the Huffman frames bit for bit; features step "
             f"{huff_steps['features']:.3f} s Huffman, {arith_steps['features']:.3f} s "
             f"arithmetic (cluster + features {huff_s:.2f} s, features {arith_s:.2f} s); "
             f"phase 23 in {time.perf_counter() - t_phase:.1f} s")
        return {"ms": ms}
    finally:
        shutil.rmtree(child["tmp"], ignore_errors=True)


def load_gen_serve(card: str, sock: str) -> dict:
    """Phase 24(a), run inside phase 15 against its warm in-thread daemon
    (no new daemon): the port's ``tools/load_gen.run_load`` over the JAX
    tool's two buckets, then over phase 4's full-size scene as the one
    bucket (``BUCKET_SPECS`` overridden as ``tests/test_serve.py`` does,
    with phase 10's first scan on disk).
    Every request must answer ok and launch each association kernel once;
    phase 24 holds the digests to direct ``run_scene`` runs."""
    from maskclustering_tpu_torch.ops import cuda as kernels
    from maskclustering_tpu_torch.tools import load_gen

    t_part = time.perf_counter()
    before = dict(kernels.LAUNCHES.counts)
    mix = load_gen.parse_tenant_mix(LOAD_TENANT_MIX)
    runs = (("buckets", load_gen.BUCKET_SPECS, LOAD_REQUESTS, LOAD_CONCURRENCY),
            ("full", ((BATCH_SCANS[0], None),), LOAD_FULL_REQUESTS, LOAD_FULL_CONCURRENCY))
    out = {"verdicts": {}, "rows": {}}
    saved = load_gen.BUCKET_SPECS
    try:
        for label, specs, n, conc in runs:
            load_gen.BUCKET_SPECS = specs
            rows = []
            v = load_gen.run_load(sock, requests=n, concurrency=conc, buckets=len(specs),
                                  deadline_s=0.0, resume=False, tenant_mix=mix, collect=rows)
            _say(f"[load] {card}: {label} verdict {json.dumps(v, sort_keys=True)}")
            if v["ok"] != n or v["failed"] or len(rows) != n:
                raise AssertionError(f"load_gen over {label}: {v}")
            _say(f"[load] {label} ({', '.join(sorted({r['scene'] for r in rows}))}): {n} "
                 f"requests at concurrency {conc}, p50 {v['value']} s, p95 {v['p95_s']} s, "
                 f"{v['throughput_rps']} requests a second over {v['wall_s']} s")
            out["verdicts"][label], out["rows"][label] = v, rows
    finally:
        load_gen.BUCKET_SPECS = saved
    launches = {n: kernels.LAUNCHES.counts.get(n, 0) - before.get(n, 0)
                for n in ASSOCIATION_KERNELS}
    served = LOAD_REQUESTS + LOAD_FULL_REQUESTS
    if any(v != served for v in launches.values()):
        raise AssertionError(f"load_gen's {served} requests launched {launches}")
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_part
    _say(f"[load] launches {json.dumps(launches)} (one of each association kernel a request); "
         f"24(a) in {out['seconds']:.1f} s inside phase 15")
    return out


def serve_reference(out_path: str) -> int:
    """``--serve-reference OUT``: phase 10's first full-size scan loaded from
    disk and clustered by ``run_scene`` on the CPU in phase 15's
    configuration, on the host post-process rung (phase 10's ladder drill
    holds its digest equal to the device rung's); the digest goes to OUT."""
    here = os.path.dirname(os.path.abspath(__file__))
    from maskclustering_tpu_torch.config import load_config
    from maskclustering_tpu_torch.datasets import get_dataset
    from maskclustering_tpu_torch.models import run_scene

    root = os.path.join(here, "build", "chip_smoke_scans")
    cfg = load_config("scannet", data_root=root, step=1, distance_threshold=0.01,
                      post_neighbor_cap=FULL_NEIGHBOR_CAP, config_name="chip_smoke_serve")
    t0 = time.perf_counter()
    tensors = get_dataset("scannet", BATCH_SCANS[0], data_root=root).load_scene_tensors(cfg.step)
    res = run_scene(tensors, cfg.replace(device_postprocess=False), device="cpu")
    with open(out_path, "w") as fh:
        json.dump({"digest": res.digest, "objects": len(res.objects.point_ids_list),
                   "seconds": time.perf_counter() - t0}, fh)
    return 0


def _start_child(tag: str, args, threads: int, env=None, nice: int = 0) -> dict:
    """A child process from the checkout's root in a session of its own
    (stopped with all it started at the script's end), its output in a log;
    ``{out}`` in ``args`` names a file in its temporary directory and
    ``{dir}`` that directory; a ``nice`` child (and all it starts) yields
    the cores to the script."""
    import shutil
    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_{tag}_")
    log = os.path.join(tmp, f"{tag}.log")
    out = os.path.join(tmp, f"{tag}.json")
    full_env = dict(os.environ, OMP_NUM_THREADS=str(threads), **(env or {}))
    prefix = ["nice", "-n", str(nice)] if nice and shutil.which("nice") else []
    t0, t0_clock = time.perf_counter(), time.time()
    with open(log, "w") as fh:
        proc = subprocess.Popen([*prefix, sys.executable,
                                 *[a.format(out=out, dir=tmp) for a in args]],
                                cwd=here, env=full_env, stdout=fh, stderr=subprocess.STDOUT,
                                text=True, start_new_session=True)
    return {"proc": proc, "t0": t0, "t0_clock": t0_clock, "tmp": tmp, "log": log, "out": out}


def start_ci_cpu() -> dict:
    """Phase 24(c): ``python -m maskclustering_tpu_torch.tools.ci --device
    cpu`` with tier-1 off, a CPU child from the head of the script (no card
    visible to it) at the lowest priority; phase 24 joins it."""
    return _start_child("ci", ["-m", "maskclustering_tpu_torch.tools.ci", "--device", "cpu"],
                        LOAD_CHILD_THREADS, env={"MCT_TIER1": "0", "CUDA_VISIBLE_DEVICES": ""},
                        nice=CPU_CHILD_NICE)


def start_load_children() -> dict:
    """Phase 24(b) and the reference of (a): the load generator's smoke and
    crash drill as children on the card, and phase 10's first scan through
    ``run_scene`` in a CPU child (``--serve-reference``), all started after
    phase 17 (whose drills read the card's memory) and joined in phase 24."""
    lg = ["-m", "maskclustering_tpu_torch.tools.load_gen", "--no-ledger", "--device", "cuda"]
    smoke = _start_child("smoke", [*lg, "--smoke", "--requests", "6", "--concurrency", "3"],
                         LOAD_CHILD_THREADS)
    crash = _start_child("crash", [*lg, "--smoke", "--crash-drill", "--requests", "4",
                                   "--concurrency", "2"], LOAD_CHILD_THREADS)
    ref = _start_child("ref", [os.path.abspath(__file__), "--serve-reference", "{out}"],
                       LOAD_CHILD_THREADS, env={"CUDA_VISIBLE_DEVICES": ""},
                       nice=CPU_CHILD_NICE)
    return {"smoke": smoke, "crash": crash, "ref": ref}


def _join(child: dict, label: str, timeout_s: float = 900) -> tuple:
    """Wait for a child; (its log, its own seconds: from its start to its
    log's last write)."""
    child["proc"].wait(timeout=timeout_s)
    wall = os.path.getmtime(child["log"]) - child["t0_clock"]
    with open(child["log"]) as fh:
        text = fh.read()
    if child["proc"].returncode != 0:
        # the lines that say why, wherever they are in a long log (a gate's
        # failing step runs long before its tail), printed after the tail so
        # that they end the error
        why = [ln for ln in text.splitlines() if "FAIL" in ln or "Error" in ln][-20:]
        raise AssertionError(f"{label} exited {child['proc'].returncode}:\n...\n"
                             f"{text[-4000:]}\n{label}: the lines that say why:\n"
                             + "\n".join(why))
    return text, wall


def _verdict_line(text: str) -> dict:
    """The last JSON object line of a tool's output."""
    for line in reversed(text.splitlines()):
        if line.startswith("{"):
            return json.loads(line)
    raise AssertionError(f"no verdict line in:\n{text[-3000:]}")


def load_gen_phase(dev, card: str, batch, load: dict, ci_cpu: dict, children: dict) -> dict:
    """Phase 24: the port's load generator and CI gate. (a) the digests of
    phase 15's load against direct ``run_scene`` runs on the card and on the
    CPU, bucket by bucket; (b) the smoke and the crash drill on the card;
    (c) the gate on the CPU."""
    import shutil

    from maskclustering_tpu_torch.datasets import get_dataset
    from maskclustering_tpu_torch.models import run_scene
    from maskclustering_tpu_torch.tools import load_gen

    t_phase = time.perf_counter()
    try:
        # (a) every served digest, bucket by bucket, against run_scene
        root = batch["root"]
        cfg = batch["cfg"].replace(config_name="chip_smoke_serve")
        served = {}
        for rows in load["rows"].values():
            for r in rows:
                served.setdefault(r["scene"], set()).add(r["digest"]["artifact"])
        ref_text, ref_wall = _join(children["ref"], "the CPU reference run")
        with open(children["ref"]["out"]) as fh:
            ref = json.load(fh)
        direct = {BATCH_SCANS[0]: {str(dev): batch["scans"][BATCH_SCANS[0]][0]["artifact"],
                                   "cpu": ref["digest"]["artifact"]}}
        for name, _ in load_gen.BUCKET_SPECS:
            tensors = get_dataset("scannet", name, data_root=root).load_scene_tensors(cfg.step)
            direct[name] = {str(d): run_scene(tensors, cfg, device=d).digest["artifact"]
                            for d in (dev, "cpu")}
        if set(served) != set(direct):
            raise AssertionError(f"served buckets {sorted(served)}, want {sorted(direct)}")
        for name, digests in sorted(served.items()):
            if len(digests) != 1 or set(direct[name].values()) != digests:
                raise AssertionError(f"{name}: served digests {sorted(digests)}, run_scene "
                                     f"{direct[name]}")
        _say(f"[load] every served digest == run_scene's on {dev} and on cpu: "
             f"{json.dumps({k: sorted(v)[0] for k, v in sorted(served.items())})} (the "
             f"full-size scan's on {dev} from phase 10, on cpu from a child started after "
             f"phase 17: {ref['seconds']:.1f} s, {ref['objects']} objects)")

        # (b) the smoke and the crash drill, children on the card
        walls = {}
        for key, label in (("smoke", "--smoke"), ("crash", "--smoke --crash-drill")):
            text, walls[key] = _join(children[key], f"load_gen {label} on the card")
            v = _verdict_line(text)
            keys = v.get("retrace_launch_keys") or 0
            bad = (v.get("ok") != v.get("requests") or v.get("failed")
                   or v.get("retrace_post_freeze") != 0 or v.get("retrace_repeats") != 0
                   or keys < len(ASSOCIATION_KERNELS)
                   or v.get("device", "").split(":")[0] != dev.type)
            if key == "crash":
                # the respawned child built nothing: on the card its kernels
                # came from the build cache the first child filled
                aot = v.get("worker_aot") or {}
                bad = bad or not v.get("worker_respawns") or v.get("retrace_compiles") != 0 \
                    or aot.get("built") or (dev.type == "cuda" and not aot.get("restored"))
            if bad:
                raise AssertionError(f"load_gen {label} on the card: {json.dumps(v)}")
            _say(f"[load] {card}: load_gen {label} on {v['device']} in {walls[key]:.1f} s: "
                 f"{v['ok']} ok, p50 {v['value']} s, p95 {v['p95_s']} s, warm-up "
                 f"{v.get('warmup_s')} s; after the freeze 0 builds and 0 new launch keys "
                 f"({keys} keys, {v.get('retrace_compiles')} builds in the last worker)"
                 + (f"; crash {v.get('worker_crashes')}, respawn {v.get('worker_respawns')}, "
                    f"the respawned child's warm-up {v.get('worker_warmup_s')} s with its "
                    f"kernels from the build cache ({json.dumps(v.get('worker_aot'))})"
                    if key == "crash" else ""))

        # (c) the gate on the CPU, a child from the head of the script
        text, walls["ci"] = _join(ci_cpu, "tools/ci.py --device cpu")
        doc = _verdict_line(text)
        if doc.get("kind") != "ci" or doc.get("rc") != 0 or len(doc.get("steps", ())) < 11:
            raise AssertionError(f"tools/ci.py --device cpu: {text[-4000:]}")
        _say(f"[load] tools/ci.py --device cpu (tier-1 off, {LOAD_CHILD_THREADS} threads at "
             f"nice {CPU_CHILD_NICE}, a child beside phases 3-23) exit 0 in "
             f"{walls['ci']:.1f} s: " + ", ".join(
                 f"{st['name']} {st['seconds']} s" for st in doc["steps"]))
        _say(f"[load] phase 24 in {time.perf_counter() - t_phase:.1f} s (its (a) "
             f"{load['seconds']:.1f} s inside phase 15)")
        return {"launches": load["launches"], "walls": walls}
    finally:
        for child in (ci_cpu, *children.values()):
            shutil.rmtree(child["tmp"], ignore_errors=True)


# 25. the device scene generator and the measurement tools: the bench's
# scene (ROADMAP A11), rendered on the card
BENCH_SCENE = {"num_boxes": 36, "num_frames": 250, "image_hw": (480, 640), "spacing": 0.025,
               "seed": 0}
BENCH_POINTS = 196608
BENCH_RUNS = 3
RENDER_CPU_FRAMES = 8
# 25(c): parity_ab on one shallow scene, its exact path the ball query's
PARITY_ARGS = ("--points", "shallow", "--scenes", "1")
PARITY_NICE = 10


# 25(a): random frames at the bench size (random poses and focal lengths,
# extreme ones included, ops/render_cases.random_frames), and the pairs the
# renderer's division form is held against torch's division on, in chunks
RENDER_RANDOM_FRAMES = 64
RENDER_QUOTIENT_PAIRS = 10 ** 8
RENDER_QUOTIENT_CHUNK = 10 ** 7


def _sass_functions(sass: str) -> dict:
    """{mangled name: [(address, instruction)]} of a ``cuobjdump -sass`` dump."""
    import re

    out = {}
    for block in re.split(r"\n\s*Function : ", sass)[1:]:
        out[block.split("\n", 1)[0].strip()] = [
            (int(a, 16), ins.strip())
            for a, ins in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", block)]
    return out


def _sass_target(ins: str):
    import re

    m = re.search(r"BRA\s+(?:`\(\.L_x_\d+\)\s*)?0x([0-9a-f]+)", ins)
    return int(m.group(1), 16) if m else None


def _sass_loops(instrs) -> list:
    """Each backward branch's loop: (head, back-branch address, body)."""
    loops = []
    for a, ins in instrs:
        head = _sass_target(ins)
        if head is not None and head < a:
            loops.append((head, a, [(x, i) for x, i in instrs if head <= x <= a]))
    return loops


def _sass_per_box(body, inner=()) -> float:
    """Instructions of a loop body a box: the body less its cold blocks (the
    range a forward conditional branch skips when it holds a call: the IEEE
    division's slow path) and less an inner loop, over the boxes an
    iteration tests (two 16-byte shared loads each)."""
    cold = set()
    for a, ins in body:
        end = _sass_target(ins)
        if ins.startswith("@") and end is not None and end > a:
            skipped = [(x, i) for x, i in body if a < x < end]
            if any(i.startswith("CALL") for _, i in skipped):
                cold.update(x for x, _ in skipped)
    cold.update(x for head, back, _ in inner for x, _ in body if head <= x <= back)
    hot = [i for a, i in body if a not in cold]
    return len(hot) / max(1, sum(i.startswith("LDS.128") for i in hot) // 2)


def render_sass(lib_path: str) -> dict:
    """The built renderer library's SASS (``cuobjdump -sass``) a (pixel, box)
    or (warp, box), on the hot path, and its kernels' registers, stack and
    local memory (``cuobjdump -res-usage``; spills land in local memory).
    The IEEE-division loop is the exact-only instantiation's; the kernel's are the
    warp's cull (one box a lane), the surviving boxes' test a pixel, and the
    per-lane loop of warps the cull does not take."""
    import re

    from maskclustering_tpu_torch.ops import cuda as kernels

    tool = os.path.join(os.path.dirname(kernels.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    res = subprocess.run([tool, "-res-usage", lib_path], capture_output=True, text=True,
                         timeout=120, check=True).stdout
    fns = _sass_functions(sass)
    old = _sass_loops(next(v for k, v in fns.items() if "render_kernelILb1E" in k))
    new = _sass_loops(next(v for k, v in fns.items() if "render_kernelILb0E" in k))

    def holding(loops, op):
        return [lp for lp in loops if any(op in i for _, i in lp[2])]

    (old_loop,), (group,) = holding(old, "FCHK"), holding(new, "VOTE")
    (inner,) = [lp for lp in new if group[0] < lp[0] and lp[1] < group[1]]
    lane = [lp for lp in holding(new, "LDS.128") if lp is not inner
            and not holding([lp], "FCHK") and not holding([lp], "VOTE")]
    usage = {("exact" if "ILb1E" in name else "new"): dict(
        zip(("reg", "stack", "local"), map(int, regs)))
        for name, *regs in re.findall(
            r"Function (\S*render_kernel\S*):\s*REG:(\d+) STACK:(\d+) SHARED:\d+ LOCAL:(\d+)",
            res)}
    return {"exact_pair": _sass_per_box(old_loop[2]),
            "survivor_pair": _sass_per_box(inner[2]),
            "cull_warp_box": _sass_per_box(group[2], (inner,)),
            "lane_pair": _sass_per_box(lane[0][2]) if lane else None,
            "usage": usage or res[:600]}


def render_exact_only(boxes, poses, intrinsics, perms, hw):
    """``render.cu``'s exact-only entry (every pixel on the IEEE-division loop), for
    timing the redesign against it in one call; on no path of the program."""
    import torch

    from maskclustering_tpu_torch.ops import cuda as kernels

    f, k = perms.shape
    dev = poses.device
    depths = torch.empty((f, *hw), dtype=torch.float32, device=dev)
    segs = torch.empty((f, *hw), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = kernels.load("render").mc_render_depth_seg_exact(
            boxes.data_ptr(), k, poses.data_ptr(), intrinsics.data_ptr(), perms.data_ptr(), f,
            hw[0], hw[1], depths.data_ptr(), segs.data_ptr(), dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"render_depth_seg_exact launch failed: CUDA error {err}")
    return depths, segs


def render_cull_shares(boxes, poses, intrinsics, hw, frames: int = 8) -> dict:
    """What the renderer's two rejections leave on ``frames`` frames, from
    the plain version's rays in torch (IEEE division gives the kernel's
    quotients in its range): the share of (pixel, box) pairs whose far
    planes give tmax > 0 (the pairs the per-lane loop divides on for their
    near planes), and the share of (warp, box) pairs the warp cull skips
    (its end-ray bounds, as ``render.cu``'s ``slab_warp`` takes them)."""
    import torch

    from maskclustering_tpu_torch.ops.geometry import fma

    h, w = hw
    dev = poses.device
    v, u = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev),
                          indexing="ij")
    u, v = u.reshape(-1).float(), v.reshape(-1).float()
    kept = warps = live = pairs = 0
    for f in range(min(frames, poses.shape[0])):
        k, c2w = intrinsics[f], poses[f]
        dx, dy = (u - k[0, 2]) / k[0, 0], (v - k[1, 2]) / k[1, 1]
        d = torch.stack([fma(dy, c2w[i, 1], dx * c2w[i, 0]) + c2w[i, 2] for i in range(3)], 1)
        sd = torch.where(d.abs() < 1e-12, torch.full_like(d, 1e-12), d)
        eye = c2w[:3, 3]
        r0, r1 = boxes[:, 0] - eye, boxes[:, 1] - eye
        lo, hi = torch.minimum(r0, r1), torch.maximum(r0, r1)  # (K, 3)
        pos = (sd > 0)[:, None, :]
        far = torch.where(pos, hi[None], lo[None]) / sd[:, None, :]
        live += int((far.amin(dim=2) > 0).sum())
        pairs += far.shape[0] * far.shape[1]
        ends = d.reshape(-1, 32, 3)[:, [0, 31]]  # (W, 2, 3), one row a warp at w % 32 == 0
        clear = ((ends >= 1e-12).all(dim=1) | (ends <= -1e-12).all(dim=1)).all(dim=1)
        e = ends[clear]  # (W', 2, 3)
        epos = (e[:, 0] > 0)[:, None, None, :]
        fr = torch.where(epos, hi[None, None], lo[None, None])  # (W', 1, K, 3)
        nr = torch.where(epos, lo[None, None], hi[None, None])
        q_far, q_near = fr / e[:, :, None, :], nr / e[:, :, None, :]  # (W', 2, K, 3)
        far_hi = q_far.amax(dim=1).amin(dim=2)
        near_lo = q_near.amin(dim=1).amax(dim=2)
        kept += int(((far_hi > 0) & (far_hi >= near_lo)).sum()) + int((~clear).sum()) * len(lo)
        warps += ends.shape[0] * len(lo)
    return {"pairs_past_far_planes": live / pairs, "warp_boxes_kept": kept / warps,
            "frames": min(frames, poses.shape[0])}


def check_render_quotients(dev) -> dict:
    """The renderer's division form (``render_quotients_cuda``) against
    torch's division on the card over RENDER_QUOTIENT_PAIRS pairs, half drawn
    over its whole range (numerators 2^-32..2^32 and 0, divisors
    2^-40..2^40, every mantissa and sign), half scene-like (corners minus
    eye in -20..20 m, ray components in -3..3, 1e-12 at least). A zero may
    differ in sign only (render.cu: no zero's sign reaches an output)."""
    import torch

    from maskclustering_tpu_torch.ops import cuda as kernels

    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    n = RENDER_QUOTIENT_CHUNK

    def floats(lo_exp, hi_exp):
        bits = (torch.randint(0, 2 ** 23, (n,), device=dev, generator=gen)
                | ((torch.randint(lo_exp, hi_exp, (n,), device=dev, generator=gen) + 127) << 23))
        v = bits.to(torch.int32).view(torch.float32)
        return torch.where(torch.rand(n, device=dev, generator=gen) < 0.5, -v, v)

    counts = {}
    for draw in ("whole", "scene"):
        bad = pairs = 0
        for _ in range(RENDER_QUOTIENT_PAIRS // (2 * n)):
            if draw == "whole":
                num, sd = floats(-32, 32), floats(-40, 40)
                num[:1024] = 0.0
            else:
                num = torch.rand(n, device=dev, generator=gen) * 40 - 20
                sd = torch.rand(n, device=dev, generator=gen) * 6 - 3
                sd = torch.where(sd.abs() < 1e-12, torch.full_like(sd, 1e-12), sd)
            got, want = kernels.render_quotients_cuda(num, sd), num / sd
            bad += int(((got.view(torch.int32) != want.view(torch.int32))
                        & ~((got == 0) & (want == 0))).sum())
            pairs += n
        counts[draw] = (pairs, bad)
    if any(bad for _, bad in counts.values()):
        raise AssertionError(f"the renderer's division form differs from torch's: {counts}")
    return counts


def start_parity_child() -> dict:
    """Phase 25(c)'s child: ``python -m maskclustering_tpu_torch.tools.parity_ab``
    on one shallow scene on the card, started after phase 17 (whose drills
    read the card's memory) at ``nice`` PARITY_NICE and joined in phase 25."""
    return _start_child("parity", ["-m", "maskclustering_tpu_torch.tools.parity_ab",
                                   *PARITY_ARGS, "--out", "{dir}/PARITY.md", "--device", "cuda"],
                        LOAD_CHILD_THREADS, nice=PARITY_NICE)


def _render_inputs(boxes, poses, intrinsics, perms, on):
    """The renderer's host arrays as the tensors its kernel and plain
    version take, on ``on``."""
    import numpy as np
    import torch

    return (*(torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(on)
              for a in (boxes, poses, intrinsics)),
            torch.from_numpy(np.ascontiguousarray(perms, dtype=np.int32)).to(on))


def _render_differs(got, want) -> int:
    """Cells where two (depth, id) renders differ: depth bits or id."""
    import torch

    return int((got[0].view(torch.int32) != want[0].view(torch.int32)).sum()
               + (got[1] != want[1]).sum())


def device_scene_phase(dev, card: str, parity_child: dict) -> dict:
    """Phase 25: (a) the renderer kernel against its plain version; (b) the
    bench scene's ``run_scene`` on card-resident frames against the same
    frames fed from the host; (c) ``parity_ab``'s child on the card."""
    import dataclasses
    import re
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from maskclustering_tpu_torch.config import PipelineConfig
    from maskclustering_tpu_torch.models import run_scene
    from maskclustering_tpu_torch.ops import cuda as kernels
    from maskclustering_tpu_torch.ops.render_cases import RENDER_CASES, random_frames
    from maskclustering_tpu_torch.utils import synthetic

    t_phase = time.perf_counter()
    try:
        # the slice's main path: the scene rendered on the card, then run_scene
        kernels.LAUNCHES.reset()
        t0 = time.perf_counter()
        tensors, _, object_of_mask = synthetic.make_scene_device(**BENCH_SCENE, device=dev)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        tensors.scene_points = synthetic.resize_scene_points(tensors.scene_points, BENCH_POINTS)
        # the renderer's inputs, from the generator's host draws: the boxes
        # are the first draws of its seed (at its default room), the poses
        # and intrinsics the scene's, and frame f's id of box k the mask
        # whose object is k + 1
        boxes_np = np.array([[lo, hi] for lo, hi in synthetic._place_boxes(
            BENCH_SCENE["num_boxes"], 4.0, np.random.default_rng(BENCH_SCENE["seed"]))[0]])
        perms_np = np.argsort(object_of_mask[:, 1:], axis=1) + 1
        host_in = (boxes_np, tensors.cam_to_world, tensors.intrinsics, perms_np)
        hw = BENCH_SCENE["image_hw"]
        f, k = perms_np.shape
        # 8 frames on the CPU's plain version, beside the runs on the card
        pool = ThreadPoolExecutor(1)
        cpu_job = pool.submit(lambda: synthetic.render_depth_seg_device(
            boxes_np, *(a[:RENDER_CPU_FRAMES] for a in host_in[1:]), hw, device="cpu"))
        cfg = PipelineConfig(config_name="chip_smoke_bench", dataset="demo",
                             distance_threshold=0.01, few_points_threshold=25, point_chunk=8192)
        t0 = time.perf_counter()
        run_scene(tensors, cfg, k_max=63, device=dev)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats(dev)
        walls, results = [], []
        for _ in range(BENCH_RUNS):
            t0 = time.perf_counter()
            results.append(run_scene(tensors, cfg, k_max=63, device=dev))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        peak_mib = torch.cuda.max_memory_allocated(dev) / 2**20
        launches = dict(kernels.LAUNCHES.counts)
        want = {"render_depth_seg": 1, **{n: BENCH_RUNS + 1 for n in ASSOCIATION_KERNELS}}
        if launches != want:
            raise AssertionError(f"phase 25's path launched {launches}, want {want}")
        res = results[-1]
        if len({json.dumps(r.digest, sort_keys=True) for r in results}) != 1:
            raise AssertionError("the bench scene's digest changed between runs")

        # (b) the same frames pulled to the host and fed through the feed
        host = dataclasses.replace(tensors, depths=tensors.depths.cpu().numpy(),
                                   segmentations=tensors.segmentations.cpu().numpy())
        fed = run_scene(host, cfg, k_max=63, device=dev)
        if fed.digest != res.digest or not np.array_equal(fed.assignment, res.assignment):
            raise AssertionError(f"card-resident digest {res.digest} != host-fed {fed.digest}")
        n_obj = len(res.objects.point_ids_list)
        if n_obj == 0 or not res.digest.get("artifact"):
            raise AssertionError(f"the bench scene produced {n_obj} objects")
        tm = {key: round(float(np.median([r.timings[key] for r in results])), 4)
              for key in res.timings}
        _say(f"[bench-scene] {card}: make_scene_device {BENCH_SCENE} rendered on {dev} in "
             f"{gen_s:.2f} s (one render_depth_seg launch); cloud resized to {BENCH_POINTS} "
             f"points; run_scene (default configuration, k_max 63, frames on the card): warm "
             f"{warm_s:.3f} s, then {[round(w, 3) for w in walls]} s (median "
             f"{float(np.median(walls)):.3f} s), peak {peak_mib:.1f} MiB, M_pad "
             f"{res.table.m_pad}, masks {res.table.num_masks}, {n_obj} objects, digest "
             f"{json.dumps(res.digest)} == the host-fed frames' on {dev}")
        _say(f"[bench-scene] timings (median of {BENCH_RUNS}, s): {json.dumps(tm)}; "
             f"launches {json.dumps(launches)}")

        # (a) the kernel against its plain version: all frames on the card
        on_card_in = _render_inputs(*host_in, dev)
        kernel_out = (tensors.depths, tensors.segmentations)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        plain_out = synthetic.render_depth_seg_reference(*on_card_in, hw)
        t1.record()
        torch.cuda.synchronize()
        plain_ms = t0.elapsed_time(t1)
        bad = _render_differs(kernel_out, plain_out)
        if bad:
            raise AssertionError(f"render_depth_seg differs from its plain version in {bad} cells")
        err = float((kernel_out[0] - plain_out[0]).abs().max())
        # the kernel against the IEEE-division loop (the exact-only entry), in turns
        if _render_differs(render_exact_only(*on_card_in, hw), plain_out):
            raise AssertionError("render.cu's exact-only entry differs from the plain version")
        times = {"exact": [], "new": []}
        for which in ("exact", "new", "new", "exact"):
            times[which].append(cuda_time_ms(
                (lambda: render_exact_only(*on_card_in, hw)) if which == "exact" else
                (lambda: kernels.render_depth_seg_cuda(*on_card_in, height=hw[0],
                                                       width=hw[1])), 5))
        ms, old_ms = min(times["new"]), min(times["exact"])
        ops, nbytes = kernels.render_ops(f, k, *hw), kernels.render_bytes(f, k, *hw)
        b_ms, b_by = bound_ms(ops, nbytes)
        cpu_out = cpu_job.result(timeout=600)
        pool.shutdown()
        head = (kernel_out[0][:RENDER_CPU_FRAMES].cpu(), kernel_out[1][:RENDER_CPU_FRAMES].cpu())
        if _render_differs(head, cpu_out):
            raise AssertionError("render_depth_seg on the card differs from the CPU's plain "
                                 "version on the first frames")
        for name, c in RENDER_CASES.items():
            args = (c["boxes"], c["poses"], c["intrinsics"], c["perms"])
            on_card = synthetic.render_depth_seg_device(*args, c["image_hw"], device=dev)
            on_cpu = synthetic.render_depth_seg_device(*args, c["image_hw"], device="cpu")
            card_plain = synthetic.render_depth_seg_reference(*_render_inputs(*args, dev),
                                                              c["image_hw"])
            got = (on_card[0].cpu(), on_card[1].cpu())
            if _render_differs(got, on_cpu) or _render_differs(on_card, card_plain):
                raise AssertionError(f"render_depth_seg differs from its plain version on "
                                     f"the case {name!r}")
        rand = random_frames(RENDER_RANDOM_FRAMES, image_hw=hw, num_boxes=k, seed=21)
        rand_in = _render_inputs(rand["boxes"], rand["poses"], rand["intrinsics"],
                                 rand["perms"], dev)
        rand_out = kernels.render_depth_seg_cuda(*rand_in, height=hw[0], width=hw[1])
        if _render_differs(rand_out, synthetic.render_depth_seg_reference(*rand_in, hw)):
            raise AssertionError("render_depth_seg differs from its plain version on the "
                                 "random frames")
        quot = check_render_quotients(dev)
        sass = render_sass(kernels.library_path("render"))
        cull = render_cull_shares(on_card_in[0], on_card_in[1], on_card_in[2], hw)
        _say(f"[render] render_depth_seg == plain on all {f} frames of the bench scene on the "
             f"card, on its first {RENDER_CPU_FRAMES} frames against the CPU's plain version, "
             f"on the {len(RENDER_CASES)} cases of ops/render_cases.py "
             f"({sorted(RENDER_CASES)}) against both, and on {RENDER_RANDOM_FRAMES} random "
             f"{hw[0]}x{hw[1]} frames of {k} boxes (random poses and focal lengths, 1e-10 to "
             f"1e9 px); its division form == torch's division on "
             + ", ".join(f"{n} {draw} pairs ({bad} differ)" for draw, (n, bad) in quot.items()))
        _say(f"[render] {card}: render_depth_seg ({f} frames of {hw[0]}x{hw[1]}, {k} boxes, "
             f"one launch): kernel {ms:.4f} ms (turns {[round(t, 4) for t in times['new']]}), "
             f"the IEEE-division loop (the exact-only entry) {old_ms:.4f} ms (turns "
             f"{[round(t, 4) for t in times['exact']]}), {old_ms / ms:.2f}x; plain "
             f"{plain_ms:.3f} ms, bound {b_ms:.5f} ms ({b_by}: {ops} FP32 ops, {nbytes} bytes), "
             f"{100 * b_ms / ms:.1f} % of the bound (the IEEE-division loop {100 * b_ms / old_ms:.1f} %)")
        _say(f"[render] SASS (cuobjdump of the built library), hot-path instructions: the "
             f"IEEE-division loop {sass['exact_pair']:.1f} a (pixel, box); the kernel's cull "
             f"{sass['cull_warp_box']:.1f} a (warp, box), its test of a box the cull keeps "
             f"{sass['survivor_pair']:.1f} a (pixel, box), the per-lane loop of warps off the "
             f"cull {sass['lane_pair']} a (pixel, box); registers, stack and local memory "
             f"(spills) {json.dumps(sass['usage'])}")
        _say(f"[render] on the bench scene's first {cull['frames']} frames: "
             f"{100 * cull['pairs_past_far_planes']:.1f} % of (pixel, box) pairs have far planes "
             f"giving tmax > 0 (the rest skip their near planes), and the warp cull keeps "
             f"{100 * cull['warp_boxes_kept']:.1f} % of (warp, box) pairs")

        # (c) parity_ab on one shallow scene, a child beside phases 18-24
        text, wall = _join(parity_child, "parity_ab")
        verdict = [ln for ln in text.splitlines() if ln.startswith("**Overall: ")]
        if not verdict or "PASS" not in verdict[-1]:
            raise AssertionError(f"parity_ab on one shallow scene: {verdict}\n{text[-4000:]}")
        m = re.search(r"kernel launches (\{.*\})", text)
        parity_launches = json.loads(m.group(1)) if m else {}
        if not parity_launches.get("ball_query"):
            raise AssertionError(f"parity_ab launched no ball query: {parity_launches}")
        rows = [ln for ln in text.splitlines() if ln.startswith("| shallow")]
        _say(f"[tools] parity_ab {' '.join(PARITY_ARGS)} on the card (a child started after "
             f"phase 17 at nice {PARITY_NICE}, {wall:.1f} s): exit 0, {verdict[-1]}; "
             f"{' '.join(rows)}; kernel launches (the exact path's ball queries) "
             f"{json.dumps(parity_launches)}")
        _say(f"[tools] phase 25 in {time.perf_counter() - t_phase:.1f} s")
        return {"launches": launches, "render": {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "max_abs_err": err, "exact_loop_ms": old_ms, "sass_pair": sass["survivor_pair"],
            "sass_exact_pair": sass["exact_pair"], "sass_cull_warp_box": sass["cull_warp_box"]},
            "parity_launches": parity_launches,
            "walls": walls, "timings": tm}
    finally:
        shutil.rmtree(parity_child["tmp"], ignore_errors=True)


def full_size_scene():
    """Phase 4's scene: 8 boxes, 32 frames at 480x640, 2 mm depth noise."""
    from maskclustering_tpu_torch.utils.synthetic import add_depth_noise, make_scene

    scene = make_scene(num_boxes=8, num_frames=32, image_hw=(480, 640), spacing=0.008,
                       floor_spacing=0.016, seed=0)
    add_depth_noise(scene, sigma=0.002, seed=1000)
    return scene


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "maskclustering_tpu_torch")):
        print("chip_smoke: the maskclustering_tpu_torch package is not beside this script",
              file=sys.stderr)
        return 2
    if sys.argv[1:] == ["--ingest-reference"]:
        sys.path.insert(0, here)
        return ingest_reference()
    if sys.argv[1:2] == ["--jpeg-kinds"] and len(sys.argv) == 3:
        sys.path.insert(0, here)
        return jpeg_kinds(sys.argv[2])
    if sys.argv[1:2] == ["--serve-reference"] and len(sys.argv) == 3:
        sys.path.insert(0, here)
        return serve_reference(sys.argv[2])
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    import numpy as np

    from maskclustering_tpu_torch.config import load_config
    from maskclustering_tpu_torch.models import run_scene
    from maskclustering_tpu_torch.obs.digest import artifact_digest
    from maskclustering_tpu_torch.ops import cuda as kernels
    from maskclustering_tpu_torch.utils.synthetic import make_scene, to_scene_tensors

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    laps, t_lap = {}, [t_start]

    def lap(phase: str) -> None:
        """Book the seconds since the last lap to ``phase``."""
        now = time.perf_counter()
        laps[phase] = round(now - t_lap[0], 1)
        t_lap[0] = now
    # every perf-ledger row of a reported run in this script lands here,
    # never in a ledger file of the checkout
    import shutil
    import tempfile

    ledger_dir = tempfile.mkdtemp(prefix="chip_smoke_ledger_")
    os.environ["MCT_PERF_LEDGER"] = os.path.join(ledger_dir, "ledger.jsonl")

    # 1. card
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    _say(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")

    lap("1")
    # phase 4's host-rendered scene, built beside phases 2-3
    from concurrent.futures import ThreadPoolExecutor

    scene_pool = ThreadPoolExecutor(1)
    t_scene = time.perf_counter()
    scene_job = scene_pool.submit(lambda: (full_size_scene(), time.perf_counter()))
    # 2. build
    t0 = time.perf_counter()
    built = kernels.build()
    _say(f"[build] {len(kernels.KERNELS)} kernel source(s), entries {list(kernels.ENTRIES)}, in "
         f"{time.perf_counter() - t0:.2f} s "
         f"(nvcc per source: {json.dumps({k: round(v, 2) for k, v in built.items()})})")

    lap("2")
    # 24(c)'s CPU gate starts here, a child process beside phases 3-23
    ci_cpu = start_ci_cpu()
    # 3. kernels against their plain versions on edge cases
    _say("[kernels] edge cases")
    check_ball_query_edges(dev)

    lap("3")
    # 4. the slice at full size
    t0 = time.perf_counter()
    scene, t_built = scene_job.result(timeout=600)
    scene_pool.shutdown()
    tensors = to_scene_tensors(scene)
    _say(f"[slice] scene built in {t_built - t_scene:.1f} s beside phases 2-3 "
         f"({time.perf_counter() - t0:.1f} s of it waited for here): "
         f"N={tensors.num_points} F={tensors.num_frames} HxW={tensors.depths.shape[1:]}")
    cfg = load_config("scannet", config_name="chip_smoke", distance_threshold=0.01,
                      use_exact_ball_query=True, device_postprocess=False)
    groups = []
    with recording_ball_query_groups(groups):
        kernels.LAUNCHES.reset()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        res = run_scene(tensors, cfg, k_max=63, seq_name="chip_smoke_full", device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES.counts)
    shapes = {k: dict(v) for k, v in kernels.LAUNCHES.shapes.items()}
    peak_mib = torch.cuda.max_memory_allocated(dev) / 2**20
    tm = res.timings
    n_obj = len(res.objects.point_ids_list)
    digest = artifact_digest(res.objects)
    _say(f"[slice] N={tensors.num_points} F={tensors.num_frames} M_pad={res.table.m_pad} "
         f"masks={res.table.num_masks} objects={n_obj} digest={digest} wall={wall:.2f} s "
         f"peak_device_mem={peak_mib:.1f} MiB")
    _say("[slice] stage walls (s): " + json.dumps(
        {"associate.host": round(tm["associate"] - tm.get("associate.ball_query", 0.0), 3),
         **{k: round(v, 3) for k, v in tm.items()}}))
    _say(f"[slice] kernel launches: {json.dumps(launches)}; shapes: "
         + json.dumps({k: {str(s): n for s, n in v.items()} for k, v in shapes.items()}))
    if launches.get("ball_query", 0) == 0:
        raise AssertionError("the exact path launched no ball_query kernel")
    if n_obj == 0:
        raise AssertionError("the full-size scene produced no objects")
    for pids in res.objects.point_ids_list:
        if pids.size == 0 or int(pids.min()) < 0 or int(pids.max()) >= tensors.num_points:
            raise AssertionError("an object holds point ids outside the scene")
    if not np.isfinite(tensors.scene_points).all():
        raise AssertionError("non-finite scene points")

    if len(groups) != launches["ball_query"]:
        raise AssertionError(f"{len(groups)} ball-query groups kept, "
                             f"{launches['ball_query']} launched")

    lap("4")
    # 5. the kernel on every group of the scene, timed
    t0 = time.perf_counter()
    bq = check_and_time_groups(dev, groups)
    share = bq["bound_ms"] / bq["ms"]
    _say(f"[kernels] ball_query == plain on all {len(groups)} groups of the scene "
         f"({time.perf_counter() - t0:.1f} s)")
    _say(f"[kernels] ball_query at its largest group {bq['shape']} (group {bq['group']}): "
         f"kernel {bq['ms']:.4f} ms, plain {bq['plain_ms']:.4f} ms, bound {bq['bound_ms']:.5f} ms "
         f"({bq['bound_by']}: {bq['pair_tests']} pair tests, {bq['bytes']} bytes), "
         f"{100 * share:.1f} % of the bound; without FMA the ceiling is "
         f"{100 * NO_FMA_CEILING:.0f} % of it, {bq['bound_ms'] / NO_FMA_CEILING:.5f} ms")
    _say(f"[kernels] ball_query summed over the scene's {len(groups)} groups: kernel "
         f"{bq['scene_ms']:.4f} ms, bound {bq['scene_bound_ms']:.5f} ms ({bq['scene_bound_by']}: "
         f"{bq['scene_pair_tests']} pair tests, {bq['scene_bytes']} bytes), "
         f"{100 * bq['scene_bound_ms'] / bq['scene_ms']:.1f} % of the bound")

    lap("5")
    # 6. card against cpu on a mid-size scene
    mid = to_scene_tensors(make_scene(num_boxes=4, num_frames=12, image_hw=(240, 320), seed=1))
    mid_cfg = load_config("scannet", config_name="chip_smoke_mid", distance_threshold=0.03,
                          few_points_threshold=10, use_exact_ball_query=True,
                          device_postprocess=False)
    on_card = run_scene(mid, mid_cfg, seq_name="mid", device=dev)
    on_cpu = run_scene(mid, mid_cfg, seq_name="mid", device="cpu")
    d_card, d_cpu = artifact_digest(on_card.objects), artifact_digest(on_cpu.objects)
    _say(f"[mid] objects cuda={len(on_card.objects.point_ids_list)} "
         f"cpu={len(on_cpu.objects.point_ids_list)} digest cuda={d_card} cpu={d_cpu}")
    if d_card != d_cpu or not np.array_equal(on_card.assignment, on_cpu.assignment):
        raise AssertionError("cuda and cpu runs of the mid-size scene differ")
    if not on_card.objects.point_ids_list:
        raise AssertionError("the mid-size scene produced no objects")

    lap("6")
    # 7. the association kernels on edge cases
    _say("[kernels] association edge cases")
    unfused = check_addcmul(dev)
    _say(f"  addcmul rounds once on cuda as on cpu (a separate multiply and add differ on "
         f"{unfused} of 1000003)")
    check_association_edges(dev)

    lap("7")
    # 8. the default configuration at full size
    dense = dense_default_full(dev, tensors)
    # 11a's, 11b's and 13b's CPU runs, a spawned process beside phases 9-12
    cpu_refs = start_cpu_references(tensors, dense["cfg"])

    lap("8")
    # 9. the default configuration, card against cpu, on the mid-size scene
    mid_digests = dense_default_mid(dev)

    lap("9")
    # 10. the batch driver on scans written to disk
    batch = batch_driver(dev, scene, make_scene(num_boxes=4, num_frames=12,
                                                image_hw=(240, 320), seed=1))

    lap("10")
    # 13d's CLI drill, a process of its own beside phases 11-13: it reads
    # phase 10's scans and writes under its own config name
    drill = _start_drill_cli(dev, batch)
    # 11. the plane digest lane and the semantic steps
    plane_digest_lane(dev, tensors, dense, mid_digests, cpu_refs)
    semantic_steps(dev, scene, batch, cpu_refs)

    lap("11")
    # 12. the CLIP encoder at ViT-H-14's full width
    clip_encoder(dev, scene, batch)

    lap("12")
    # 13. streaming and the fault drills
    stream = streaming_phase(dev, tensors, dense, batch, cpu_refs, drill)

    lap("13")
    # 14. the fused multi-device path
    mesh = mesh_phase(dev, card, tensors, dense, mid_digests, batch, cpu_refs)
    cpu_refs["pool"].shutdown()

    lap("14")
    # 15. the scene-serving daemon
    serve = serve_phase(dev, card, dense, batch)

    lap("15")
    # 16. the run report, ledger, trace, top and the canary sentinel; 17(a)'s
    # daemon starts once its timed runs are done, beside the rest of it
    iso_early = {}
    obs_run = obs_phase(dev, card, tensors, dense, batch,
                        after_timing=lambda: iso_early.update(start_isolated(batch)))

    lap("16")
    # 17. the crash-contained topology: isolated worker, drills, the pool
    iso = isolation_phase(dev, card, batch, serve, iso_early)

    lap("17")
    # 22's cpu run starts here, a child process beside phases 18-21
    demo_cpu = start_demo_cpu()
    # 23's fixture check starts here, a child process beside phases 18-22
    kinds_cpu = start_jpeg_kinds_cpu()
    # 24(b)'s children on the card and (a)'s CPU reference, beside 18-23
    load_children = start_load_children()
    # 25(c)'s parity_ab on the card, beside 18-24
    parity_child = start_parity_child()
    # 18. the ingestion front: a .sens capture exported, masked, clustered
    ingest = ingest_phase(dev, card, scene)

    lap("18")
    # 19. visualisation and the TASMap variant
    vis = vis_phase(dev, card, batch)

    lap("19")
    # 20. the static checks, and a scan under the lock sanitizer
    static_checks_phase(dev, card, batch)

    lap("20")
    # 21. the tooling: cost observatory, build cache, analyzer, profiler,
    # guard, sanitizer
    tooling_phase(dev, card, tensors, dense, batch)

    lap("21")
    # 22. the zero-download demo on the card against its cpu child
    demo_run = demo_phase(dev, card, demo_cpu)

    lap("22")
    # 23. the JPEG kinds: the child's goldens and refusals, then the
    # features step over arithmetic-coded frames on the card
    jpeg_kinds_phase(dev, card, kinds_cpu)

    lap("23")
    # 24. the load generator and the CI gate: (a)'s digests, (b)'s children
    # on the card, (c)'s gate on the CPU
    load = load_gen_phase(dev, card, batch, serve["load"], ci_cpu, load_children)

    lap("24")
    # 25. the device scene generator (the renderer kernel and the bench
    # scene on card-resident frames) and the measurement tools
    bench = device_scene_phase(dev, card, parity_child)

    lap("25")
    _say(f"[done] {time.perf_counter() - t_start:.1f} s; phases (s): {json.dumps(laps)}")
    _say(card)
    rows = [{
        "name": "ball_query", "route": "cuda", "kind": "pallas",
        "source": "maskclustering_tpu_torch/ops/cuda/ball_query.cu",
        "replaces": "maskclustering_tpu/ops/pallas/ball_query.py:127",
        "launches": launches["ball_query"], "max_abs_err": bq["max_abs_err"],
        "ms": bq["ms"], "plain_ms": bq["plain_ms"], "bound_ms": bq["bound_ms"],
        "bound_by": bq["bound_by"], "library_ms": None, "scene_kernel_ms": bq["scene_ms"],
        "ingest_launches": ingest["launches"]["ball_query"],
        "tasmap_launches": vis["tasmap_launches"].get("ball_query", 0),
        "parity_launches": bench["parity_launches"].get("ball_query", 0)}]
    # the JAX lines each association kernel computes (associate_frame, :191)
    replaces = {"associate_table": "maskclustering_tpu/models/backprojection.py:264",
                "associate_claim": "maskclustering_tpu/models/backprojection.py:229",
                "associate_assign": "maskclustering_tpu/models/backprojection.py:347"}
    for name, t in dense["timed"].items():
        rows.append({
            "name": name, "route": "cuda", "kind": "xla_program",
            "source": "maskclustering_tpu_torch/ops/cuda/associate.cu",
            "replaces": replaces[name],
            "launches": dense["launches"][name], "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None, "scene_kernel_ms": t["ms"],
            "batch_launches": batch["launches"][name],
            "stream_launches": stream["launches"][name],
            "mesh_launches": mesh["launches"][name],
            "serve_launches": serve["launches"][name],
            "canary_launches": obs_run["canary_launches"].get(name, 0),
            "isolated_launches": iso["launches"][name],
            "ingest_launches": ingest["launches"][name],
            "tasmap_launches": vis["tasmap_launches"][name],
            "demo_launches": demo_run["launches"][name],
            "load_gen_launches": load["launches"][name]})
    # the render entry's kernels count project_zbuffer's launches over the
    # scan's (object, frame) pairs; the box counts the top_images step's
    for name, t in vis["timed"].items():
        rows.append({
            "name": name, "route": "cuda", "kind": "xla_program",
            "source": "maskclustering_tpu_torch/ops/cuda/splat.cu",
            "replaces": ("maskclustering_tpu/visualize/top_images.py:66" if name == "splat_bbox"
                         else "maskclustering_tpu/visualize/top_images.py:25"),
            "launches": (vis["launches"] if name == "splat_bbox"
                         else vis["render_launches"]).get(name, 0),
            "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None, "scene_kernel_ms": t["scene_ms"],
            "trace_kernel_ms": t["kernel_ms"], "trace_scene_kernel_ms": t["scene_kernel_ms"],
            "step_launches": vis["launches"].get(name, 0),
            "tasmap_launches": vis["tasmap_launches"].get(name, 0),
            **({"demo_launches": demo_run["launches"][name]} if name == "splat_bbox" else {})})
    # the renderer of the device scene generator (phase 25's main path)
    rows.append({
        "name": "render_depth_seg", "route": "cuda", "kind": "xla_program",
        "source": "maskclustering_tpu_torch/ops/cuda/render.cu",
        "replaces": "maskclustering_tpu/utils/synthetic.py:257",
        "launches": bench["launches"]["render_depth_seg"], **bench["render"],
        "library_ms": None, "scene_kernel_ms": bench["render"]["ms"]})
    shutil.rmtree(ledger_dir, ignore_errors=True)
    _say(json.dumps({"kernels": rows}))
    _say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    _adopt_orphans()
    try:
        rc = main()
    finally:
        # every child, the ones in sessions of their own and all they
        # started, whether the run passed or failed
        _stop_descendants()
    sys.exit(rc)
