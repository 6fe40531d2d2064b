"""The port's streaming accumulator (``models/streaming.py``) against the
JAX package's, on the CPU.

The same inputs, made from a seed, go through the jitted JAX function and
the port at ``device="cpu"``; everything compared is an integer, a bool or
an exact {0, 1} float32 sum, so every comparison is exact:

- the three programs (merge, re-cluster, rep-plane vote) on the same state,
  under both ``count_dtype`` values, a rep-vote tie and dropped containment
  columns included;
- the clustering warm start against the JAX warm start;
- a chunk covering the scene: byte-identical to the port's ``run_scene``
  and equal to the JAX ``stream_scene``, under both encodings;
- four chunks: every chunk's digest, partial count and mask count, the
  final objects, assignment and digest equal to JAX's, under both encodings;
- residency: one padded shape for every chunk, a partial last one included;
- chunk faults (flaky heals, terminal raises) and the abandoned-attempt
  epoch fence;
- the state journal: resumed from the port's own, from a JAX-written one and
  the reverse; removed by ``stream_scene`` once the scene is done;
- the batch driver's streaming route and ``--streaming-chunk`` on scans on
  disk, equal to the JAX driver's artifacts;
- the configuration refusals.

The scene is the JAX streaming tests' (``tests/test_streaming.py:65-76``).
"""

import dataclasses
import logging
import os
import signal
import threading
import time
from unittest import mock

import numpy as np
import pytest
import torch

from maskclustering_tpu.config import load_config as jax_load_config
from maskclustering_tpu.models import streaming as jax_streaming
from maskclustering_tpu.models.clustering import iterative_clustering as jax_iterative_clustering
from maskclustering_tpu.models.pipeline import bucket_k_max
from maskclustering_tpu.utils import faults as jax_faults
from maskclustering_tpu.utils.synthetic import make_scene, to_scene_tensors, write_scannet_layout
from maskclustering_tpu_torch.config import from_jax_config
from maskclustering_tpu_torch.models import streaming
from maskclustering_tpu_torch.models.clustering import iterative_clustering
from maskclustering_tpu_torch.models.pipeline import run_scene
from maskclustering_tpu_torch.run import cluster_scene, main
from maskclustering_tpu_torch.utils import faults
from maskclustering_tpu_torch.utils.compile_cache import max_seg_id, scene_pads

# one intra-op thread: the suite runs in parallel worker processes
torch.set_num_threads(1)

SCENE = "scene0001_00"
FRAMES = 16
DTYPES = ("bf16", "int8")


@pytest.fixture(autouse=True)
def _clean_fault_state():
    for mod in (faults, jax_faults):
        mod.set_plan(None)
        mod.clear_stop()
    yield
    for mod in (faults, jax_faults):
        mod.set_plan(None)
        mod.clear_stop()


@pytest.fixture(scope="module")
def scene_pack(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("stream_data"))
    scene = make_scene(num_boxes=3, num_frames=FRAMES, image_hw=(48, 64), seed=7, spacing=0.05)
    write_scannet_layout(scene, root, SCENE)
    return {"root": root, "scene": scene, "tensors": to_scene_tensors(scene)}


def _jax_cfg(root, **kw):
    return jax_load_config("scannet").replace(
        data_root=root, config_name="streamtest", step=1, distance_threshold=0.05,
        mask_pad_multiple=32, frame_pad_multiple=4, point_chunk=2048, retry_backoff_s=0.01,
        **kw)


def _cfg(root, **kw):
    return from_jax_config(dataclasses.asdict(_jax_cfg(root, **kw)))


def _k_max(tensors):
    return bucket_k_max(max_seg_id(tensors.segmentations))


def _chunks(tensors, chunk):
    return [streaming.slice_scene_frames(tensors, s, min(s + chunk, FRAMES))
            for s in range(0, FRAMES, chunk)]


def _assert_objects_equal(a, b):
    assert len(a.point_ids_list) == len(b.point_ids_list)
    for pa, pb in zip(a.point_ids_list, b.point_ids_list):
        np.testing.assert_array_equal(np.asarray(pa), np.asarray(pb))
    assert a.mask_list == b.mask_list
    assert a.num_points == b.num_points


def _assert_results_equal(a, b):
    _assert_objects_equal(a.objects, b.objects)
    np.testing.assert_array_equal(np.asarray(a.assignment), np.asarray(b.assignment))
    for field in ("frame", "mask_id", "valid"):
        np.testing.assert_array_equal(getattr(a.table, field), getattr(b.table, field))
    assert a.digest == b.digest


def _drive(acc, chunks):
    return [acc.push_chunk(c) for c in chunks]


@pytest.fixture(scope="module", params=DTYPES)
def stream4(request, scene_pack):
    """The four-chunk stream in both packages: chunk dicts and results."""
    tensors, root = scene_pack["tensors"], scene_pack["root"]
    jcfg = _jax_cfg(root, streaming_chunk=4, count_dtype=request.param)
    k_max = _k_max(tensors)
    jacc = jax_streaming.StreamAccumulator(jcfg, total_frames=FRAMES,
                                           num_points=tensors.num_points, k_max=k_max,
                                           seq_name=SCENE)
    jdicts = _drive(jacc, _chunks(tensors, 4))
    shapes = []
    real = streaming.associate_scene_tensors

    def recording(padded, *args, **kwargs):
        shapes.append((padded.depths.shape[0], padded.scene_points.shape[0]))
        return real(padded, *args, **kwargs)

    pacc = streaming.StreamAccumulator(from_jax_config(dataclasses.asdict(jcfg)),
                                       total_frames=FRAMES, num_points=tensors.num_points,
                                       k_max=k_max, seq_name=SCENE, device="cpu")
    with mock.patch.object(streaming, "associate_scene_tensors", recording):
        pdicts = _drive(pacc, _chunks(tensors, 4))
    return {"count_dtype": request.param, "jax": jdicts, "port": pdicts,
            "jax_result": jacc.finalize(), "port_result": pacc.finalize(), "shapes": shapes,
            "acc": pacc}


@pytest.fixture(scope="module")
def port_stream4(scene_pack):
    """The port's four-chunk stream (bf16): the fault-free reference of the
    fault and journal tests, which ``stream4`` holds equal to JAX's."""
    tensors = scene_pack["tensors"]
    acc = streaming.StreamAccumulator(_cfg(scene_pack["root"], streaming_chunk=4),
                                      total_frames=FRAMES, num_points=tensors.num_points,
                                      k_max=_k_max(tensors), seq_name=SCENE, device="cpu")
    dicts = _drive(acc, _chunks(tensors, 4))
    return {"dicts": dicts, "result": acc.finalize()}


# ---------------------------------------------------------------------------
# the three programs
# ---------------------------------------------------------------------------


def _merge_inputs(rng, m=64, f_alloc=12, fc=4, n=4096, mk=16, k_max=7):
    """An accumulator state with live representatives whose points the
    chunk's masks claim (so the cross terms are not all empty), and noise."""
    rep_slots = np.array([0, 5, 10, 17, 23, 31, 36])
    assignment = np.arange(m, dtype=np.int32)
    for r in rep_slots:
        assignment[r + 1:r + 3] = r
    active = rng.random(m) < 0.8
    active[rep_slots] = True
    active[40:] = False  # the chunk's slots are not live yet
    group = np.arange(n) * len(rep_slots) // n
    rep_plane = np.where(rng.random(n) < 0.1, 0, rep_slots[group] + 1).astype(np.int32)
    # frame f: rep i's points carry id 1 + (i + f) % k_max, 15 % noise
    mop = np.stack([1 + (group + f) % k_max for f in range(fc)])
    noise = rng.random(mop.shape) < 0.15
    mop = np.where(noise, rng.integers(0, k_max + 1, mop.shape), mop).astype(np.int32)
    # the chunk's mask table: (frame, id)-sorted, padding frame fc and id -1
    frame = np.full(mk, fc, np.int32)
    mid = np.full(mk, -1, np.int32)
    rows = [(f, i) for f in range(fc) for i in (1, 2, 4, 5) if (f, i) != (3, 5)][:mk - 1]
    frame[:len(rows)] = [r[0] for r in rows]
    mid[:len(rows)] = [r[1] for r in rows]
    return dict(
        visible_acc=rng.random((m, f_alloc)) < 0.3,
        contained_acc=rng.random((m, m)) < 0.05,
        active_acc=active,
        n_tot_acc=rng.integers(0, 500, m).astype(np.float32),
        assignment=assignment,
        rep_plane=rep_plane,
        mask_of_point=mop,
        vis_k=rng.random((mk, fc)) < 0.4,
        con_k=rng.random((mk, mk)) < 0.1,
        act_k=(rng.random(mk) < 0.9) & (mid >= 0),
        ntot_k=rng.integers(0, 300, mk).astype(np.float32),
        chunk_frame=frame,
        chunk_id=mid,
        slot_offset=np.int32(40),
        frames_base=np.int32(4),
    ), k_max


@pytest.mark.parametrize("count_dtype", DTYPES)
def test_stream_merge_equals_jax(count_dtype):
    inputs, k_max = _merge_inputs(np.random.default_rng(11))
    static = dict(k_max=k_max, point_chunk=1024, mask_visible_threshold=0.3,
                  contained_threshold=0.8, big_mask_point_count=500,
                  count_dtype=count_dtype)
    want = jax_streaming._stream_merge_impl(*inputs.values(), **static)
    args = [torch.from_numpy(np.asarray(v)) for v in list(inputs.values())[:-2]]
    got = streaming._stream_merge(*args, int(inputs["slot_offset"]),
                                  int(inputs["frames_base"]), **static)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    visible, contained = (np.asarray(w) for w in want[:2])
    # the cross terms fired (a rep contained by a chunk mask), and most
    # (rep, frame) pairs went to the dropped column
    new_cols = contained[:, 40:56] & ~inputs["contained_acc"][:, 40:56]
    assert new_cols[:40].any()
    assert new_cols[:40].sum() < 40 * inputs["mask_of_point"].shape[0]
    # the window did not move: rows below the chunk keep the old columns
    assert visible[:, :4].tolist() == inputs["visible_acc"][:, :4].tolist()


def test_stream_merge_refuses_a_window_that_does_not_fit():
    inputs, k_max = _merge_inputs(np.random.default_rng(11))
    args = [torch.from_numpy(np.asarray(v)) for v in list(inputs.values())[:-2]]
    with pytest.raises(ValueError, match="exceed"):
        streaming._stream_merge(*args, 60, 4, k_max=k_max, point_chunk=1024,
                                mask_visible_threshold=0.3, contained_threshold=0.8,
                                big_mask_point_count=500, count_dtype="bf16")


@pytest.mark.parametrize("count_dtype", DTYPES)
def test_stream_recluster_equals_jax(count_dtype):
    rng = np.random.default_rng(5)
    m, f = 64, 12
    visible = rng.random((m, f)) < 0.4
    contained = rng.random((m, m)) < 0.15
    active = rng.random(m) < 0.9
    prev = np.arange(m, dtype=np.int32)
    prev[1::4] = prev[0::4][:len(prev[1::4])]  # a partial prior merge
    static = dict(max_len=20, view_consensus_threshold=0.9, count_dtype=count_dtype)
    want = jax_streaming._stream_recluster_impl(visible, contained, active, prev, **static)
    got = streaming._stream_recluster(*(torch.from_numpy(a) for a in
                                        (visible, contained, active, prev)), **static)
    for field in ("assignment", "node_visible", "node_active"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)))
    assert len(np.unique(np.asarray(want.assignment))) < m


def test_rep_plane_update_equals_jax_with_ties():
    rng = np.random.default_rng(9)
    m, fc, n, k = 48, 4, 3000, 9
    assignment = np.arange(m, dtype=np.int32)
    assignment[1::3] = assignment[0::3][:len(assignment[1::3])]
    rep_plane = rng.integers(0, m + 1, n).astype(np.int32)
    rep_votes = rng.integers(0, 4, n).astype(np.int32)
    first = rng.integers(0, k + 1, (fc, n)).astype(np.int16)
    last = np.where(rng.random((fc, n)) < 0.5, first, rng.integers(0, k + 1, (fc, n))
                    ).astype(np.int16)
    slot_of = rng.integers(-1, m, (fc, k + 2)).astype(np.int32)
    # point 0: a tie, one vote for its prior rep (slot 3 + 1) against one for
    # slot 6's rep through a first claim, nothing else: the prior must win
    rep_plane[0], rep_votes[0] = 4, 1
    first[:, 0], last[:, 0] = 0, 0
    first[0, 0] = 2
    slot_of[0, 2] = 6
    static = dict(chunk_frames=3, min_points=4)
    want = jax_streaming._rep_plane_update_impl(rep_plane, rep_votes, first, last, slot_of,
                                                assignment, **static)
    got = streaming._rep_plane_update(*(torch.from_numpy(a) for a in
                                        (rep_plane, rep_votes, first, last, slot_of,
                                         assignment)), **static)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[0][0]) == assignment[3] + 1 != assignment[6] + 1
    assert int(got[1][0]) == 1


# ---------------------------------------------------------------------------
# the warm start
# ---------------------------------------------------------------------------


def test_warm_start_equals_jax_warm_start():
    """The JAX refinement and idempotence cases (``tests/test_streaming.py:153-184``)
    through both packages: a refinement of the final components gives the
    cold solve, the cold fixpoint is idempotent, and every result equals
    the JAX warm start's."""
    rng = np.random.default_rng(0)
    m, f = 64, 12
    visible = rng.random((m, f)) < 0.4
    contained = rng.random((m, m)) < 0.15
    active = np.ones(m, bool)
    schedule = np.full(20, np.inf, np.float32)
    schedule[:3] = [3.0, 2.0, 1.0]
    t = [torch.from_numpy(a) for a in (visible, contained, active, schedule)]

    cold = iterative_clustering(*t)
    cold_assign = cold.assignment.numpy()
    np.testing.assert_array_equal(
        cold_assign, np.asarray(jax_iterative_clustering(visible, contained, active,
                                                         schedule).assignment))
    refine = np.asarray([min(j for j in range(m) if cold_assign[j] == cold_assign[i]
                             and j % 2 == i % 2) for i in range(m)], dtype=np.int32)
    for init in (refine, cold_assign, np.arange(m, dtype=np.int32)):
        warm = iterative_clustering(*t, torch.from_numpy(init))
        want = jax_iterative_clustering(visible, contained, active, schedule, init)
        np.testing.assert_array_equal(warm.assignment.numpy(), cold_assign)
        np.testing.assert_array_equal(warm.assignment.numpy(), np.asarray(want.assignment))
        np.testing.assert_array_equal(warm.node_visible.numpy(), cold.node_visible.numpy())
        np.testing.assert_array_equal(warm.node_visible.numpy(), np.asarray(want.node_visible))


# ---------------------------------------------------------------------------
# one chunk covering the scene; four chunks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("count_dtype", DTYPES)
def test_single_chunk_stream_equals_batch_and_jax(scene_pack, count_dtype, tmp_path):
    tensors, root = scene_pack["tensors"], scene_pack["root"]
    cfg = _cfg(root, count_dtype=count_dtype)
    out = {}
    for tag, c in (("batch", cfg), ("stream", cfg.replace(streaming_chunk=FRAMES + 3))):
        od, pred = str(tmp_path / tag / "od"), str(tmp_path / tag / "pred")
        run = run_scene if tag == "batch" else streaming.stream_scene
        out[tag] = run(tensors, c, seq_name=SCENE, export=True, object_dict_dir=od,
                       prediction_root=pred, device="cpu")
        out[tag + "_files"] = [open(os.path.join(*p), "rb").read() for p in (
            (pred, "streamtest_class_agnostic", f"{SCENE}.npz"),
            (od, "streamtest", "object_dict.npy"))]
    _assert_results_equal(out["stream"], out["batch"])
    assert out["stream"].digest["plane"]
    assert out["stream_files"] == out["batch_files"]
    want = jax_streaming.stream_scene(tensors, _jax_cfg(root, count_dtype=count_dtype,
                                                        streaming_chunk=FRAMES),
                                      seq_name=SCENE)
    _assert_results_equal(out["stream"], want)


def test_four_chunk_stream_equals_jax(stream4):
    keys = ("chunk", "frames", "frames_done", "total_frames", "masks", "partial_instances",
            "plane_bytes", "digest", "done")
    assert [{k: d[k] for k in keys} for d in stream4["port"]] == \
        [{k: d[k] for k in keys} for d in stream4["jax"]]
    assert [d["partial_instances"] for d in stream4["port"]][-1] == 3
    assert stream4["port"][0]["partial_instances"] > 0
    _assert_results_equal(stream4["port_result"], stream4["jax_result"])
    assert stream4["port_result"].digest["count_dtype"] == stream4["count_dtype"]
    assert len(stream4["port_result"].objects.point_ids_list) == 3


def test_four_chunk_residency(scene_pack, stream4):
    """Every chunk pads to the one (f_chunk_pad, n_pad) bucket, and one
    chunk's planes stay under the full scene's plane set."""
    tensors = scene_pack["tensors"]
    cfg = _cfg(scene_pack["root"], streaming_chunk=4)
    f_chunk, n_pad = scene_pads(cfg, 4, tensors.num_points)
    assert stream4["shapes"] == [(f_chunk, n_pad)] * 4
    f_full, _ = scene_pads(cfg, FRAMES, tensors.num_points)
    full_set = f_full * n_pad * (4 + 2 + 2 + 1) + n_pad
    assert max(d["plane_bytes"] for d in stream4["port"]) < full_set
    acc = stream4["acc"]
    partial = acc.partial_objects()
    assert len(partial.point_ids_list) == 3 and partial.num_points == tensors.num_points


def test_partial_last_chunk_pads_to_the_same_bucket(scene_pack):
    """Chunks of 5 over 16 frames (5, 5, 5, 1) all pad to the JAX package's
    one bucket for a chunk of 5."""
    from maskclustering_tpu.utils.compile_cache import scene_pads as jax_scene_pads

    tensors, root = scene_pack["tensors"], scene_pack["root"]
    shapes = []
    real = streaming.associate_scene_tensors

    def recording(padded, *args, **kwargs):
        shapes.append((padded.depths.shape[0], padded.scene_points.shape[0]))
        return real(padded, *args, **kwargs)

    with mock.patch.object(streaming, "associate_scene_tensors", recording):
        got = streaming.stream_scene(tensors, _cfg(root, streaming_chunk=5), seq_name=SCENE,
                                     device="cpu")
    assert shapes == [jax_scene_pads(_jax_cfg(root), 5, tensors.num_points)] * 4
    assert got.timings["stream.num_chunks"] == 4 and got.digest["bucket"].startswith("k63:f8:")


# ---------------------------------------------------------------------------
# chunk faults and the epoch fence
# ---------------------------------------------------------------------------


def test_flaky_chunk_retries_and_heals(scene_pack, port_stream4, caplog):
    faults.set_plan(faults.FaultPlan.from_spec(f"flaky:{SCENE}.chunk:1"))
    with caplog.at_level(logging.WARNING, logger="maskclustering_tpu_torch"):
        result = streaming.stream_scene(scene_pack["tensors"],
                                        _cfg(scene_pack["root"], streaming_chunk=4),
                                        seq_name=SCENE, device="cpu")
    retries = [r for r in caplog.records if "chunk 0 failed" in r.getMessage()]
    assert len(retries) == 1 and "retry 1/2" in retries[0].getMessage()
    _assert_results_equal(result, port_stream4["result"])


def test_terminal_chunk_fault_raises_without_retry(scene_pack, caplog):
    faults.set_plan(faults.FaultPlan.from_spec(f"terminal:{SCENE}.chunk:1"))
    with caplog.at_level(logging.WARNING, logger="maskclustering_tpu_torch"):
        with pytest.raises(faults.InjectedFault) as err:
            streaming.stream_scene(scene_pack["tensors"],
                                   _cfg(scene_pack["root"], streaming_chunk=4),
                                   seq_name=SCENE, device="cpu")
    assert not err.value.retryable
    assert not [r for r in caplog.records if "retry" in r.getMessage()]


@pytest.mark.parametrize("held_at", ["pull", "merge"])
def test_abandoned_chunk_attempt_cannot_double_bind(scene_pack, held_at):
    """The epoch fence (``tests/test_streaming.py:343-385``): an attempt that
    a retry superseded raises ``StaleChunkAttempt`` on its own thread, and
    exactly one chunk is accumulated. Held at the pull seam, it is fenced
    where it would size the state; held in the merge program, at its bind."""
    tensors = scene_pack["tensors"]
    acc = streaming.StreamAccumulator(
        _cfg(scene_pack["root"], streaming_chunk=4), total_frames=FRAMES,
        num_points=tensors.num_points, k_max=_k_max(tensors), seq_name=SCENE, device="cpu")
    chunk = streaming.slice_scene_frames(tensors, 0, 4)
    gate, held = threading.Event(), []
    real_merge = streaming._stream_merge

    def merge(*args, **kwargs):
        if held_at == "merge" and not held:
            held.append(True)
            gate.wait(30.0)
        return real_merge(*args, **kwargs)

    if held_at == "pull":
        faults.set_plan(faults.FaultPlan.from_spec(f"stall:{SCENE}.pull:1", stall_s=1.0))
    raised = []

    def abandoned():
        try:
            acc.push_chunk(chunk)
        except Exception as e:  # noqa: BLE001 — the type is asserted below
            raised.append(e)

    with mock.patch.object(streaming, "_stream_merge", merge):
        t = threading.Thread(target=abandoned, daemon=True)
        t.start()
        deadline = time.monotonic() + 30.0
        while held_at == "merge" and not held and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.3)  # the abandoned attempt is inside its stall
        digest = acc.push_chunk(chunk)  # the retry supersedes it
        state = [acc.visible.clone(), acc.contained.clone(), acc.rep_plane.clone()]
        gate.set()
        t.join(30.0)
    assert not t.is_alive()
    assert len(raised) == 1 and isinstance(raised[0], streaming.StaleChunkAttempt), raised
    assert acc.chunks_done == 1 and acc.frames_done == 4 and digest["chunk"] == 0
    # what the abandoned attempt computed never reached the bound state
    for before, now in zip(state, (acc.visible, acc.contained, acc.rep_plane)):
        assert torch.equal(before, now)


# ---------------------------------------------------------------------------
# the state journal
# ---------------------------------------------------------------------------


def _accumulators(scene_pack, count_dtype="bf16"):
    tensors, root = scene_pack["tensors"], scene_pack["root"]
    jcfg = _jax_cfg(root, streaming_chunk=4, count_dtype=count_dtype)
    kw = dict(total_frames=FRAMES, num_points=tensors.num_points, k_max=_k_max(tensors),
              seq_name=SCENE)
    return (lambda: jax_streaming.StreamAccumulator(jcfg, **kw),
            lambda: streaming.StreamAccumulator(from_jax_config(dataclasses.asdict(jcfg)),
                                                device="cpu", **kw))


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("jax", "port"), ("port", "jax")])
def test_resume_from_journal(scene_pack, port_stream4, tmp_path, writer, reader):
    """A journal written after two chunks, by either package, resumes in
    either: the last two chunks then give the uninterrupted stream's answer."""
    make = dict(zip(("jax", "port"), _accumulators(scene_pack)))
    chunks = _chunks(scene_pack["tensors"], 4)
    path = str(tmp_path / f"{SCENE}.stream.npz")
    acc1 = make[writer]()
    for c in chunks[:2]:
        acc1.push_chunk(c)
        acc1.save_state(path)
    acc2 = make[reader]()
    assert acc2.load_state(path)
    assert acc2.chunks_done == 2 and acc2.frames_done == 8
    dicts = _drive(acc2, chunks[2:])
    assert [d["digest"] for d in dicts] == [d["digest"] for d in port_stream4["dicts"][2:]]
    _assert_results_equal(acc2.finalize(), port_stream4["result"])


def test_journal_refuses_another_chunking(scene_pack, tmp_path):
    _, make_port = _accumulators(scene_pack)
    path = str(tmp_path / "s.stream.npz")
    acc = make_port()
    acc.push_chunk(_chunks(scene_pack["tensors"], 4)[0])
    acc.save_state(path)
    tensors = scene_pack["tensors"]
    other = streaming.StreamAccumulator(
        _cfg(scene_pack["root"], streaming_chunk=8), total_frames=FRAMES,
        num_points=tensors.num_points, k_max=_k_max(tensors), seq_name=SCENE, device="cpu")
    assert not other.load_state(path)
    assert not make_port().load_state(str(tmp_path / "absent.npz"))


def test_two_threads_journal_one_scene_into_one_path(scene_pack, tmp_path):
    """``save_state`` writes through a temporary file of its own: two
    threads snapshotting one scene into one path at once (two slices on one
    state directory) never share a file. Neither raises, the snapshot holds
    a single save's members byte for byte (``np.savez`` stamps the time into
    each member's zip header), no temporary file is left, and it resumes."""
    import zipfile

    _, make_port = _accumulators(scene_pack)
    acc = make_port()
    acc.push_chunk(_chunks(scene_pack["tensors"], 4)[0])
    single = str(tmp_path / "single" / "s.stream.npz")
    acc.save_state(single)
    path = str(tmp_path / "shared" / "s.stream.npz")
    errors = []
    for _ in range(20):
        start = threading.Barrier(2)

        def save():
            try:
                start.wait(10.0)
                acc.save_state(path)
            except Exception as e:  # noqa: BLE001 — asserted below
                errors.append(repr(e))

        threads = [threading.Thread(target=save) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
    assert errors == []

    def members(p):
        with zipfile.ZipFile(p) as zf:
            return {name: zf.read(name) for name in zf.namelist()}

    assert members(path) == members(single)
    assert os.listdir(os.path.dirname(path)) == ["s.stream.npz"]
    assert make_port().load_state(path)


def test_stream_scene_resumes_and_removes_its_journal(scene_pack, port_stream4, tmp_path,
                                                     caplog):
    _, make_port = _accumulators(scene_pack)
    state_dir = str(tmp_path / "state")
    path = streaming.stream_state_path(state_dir, SCENE)
    acc = make_port()
    acc.push_chunk(_chunks(scene_pack["tensors"], 4)[0])
    acc.save_state(path)
    with caplog.at_level(logging.INFO, logger="maskclustering_tpu_torch"):
        result = streaming.stream_scene(scene_pack["tensors"],
                                        _cfg(scene_pack["root"], streaming_chunk=4),
                                        seq_name=SCENE, state_dir=state_dir, resume=True,
                                        device="cpu")
    assert any("resumed at chunk 1/4" in r.getMessage() for r in caplog.records)
    assert not os.path.exists(path), "a finished stream must drop its journal"
    _assert_results_equal(result, port_stream4["result"])


# ---------------------------------------------------------------------------
# the batch driver
# ---------------------------------------------------------------------------


def _npz_equal(a, b):
    with np.load(a) as x, np.load(b) as y:
        assert sorted(x.files) == sorted(y.files)
        for key in x.files:
            np.testing.assert_array_equal(x[key], y[key])


def test_cluster_scene_routes_streaming(scene_pack, stream4, tmp_path):
    """The driver's scene step streams a streaming configuration; its
    artifacts equal the JAX stream's, exported by the JAX writer."""
    from maskclustering_tpu.models.postprocess import export_artifacts as jax_export

    root = scene_pack["root"]
    cfg = _cfg(root, streaming_chunk=4, count_dtype=stream4["count_dtype"])
    cfg = cfg.replace(config_name="streamrun" + stream4["count_dtype"])
    st = cluster_scene(cfg, SCENE, resume=False, device="cpu")
    assert st.status == "ok", st.error
    assert st.num_objects == 3
    assert "stream.total" in st.timings and st.timings["stream.num_chunks"] == 4
    assert st.digest == stream4["jax_result"].digest and st.digest_coord.endswith("|c4")
    jax_export(stream4["jax_result"].objects, SCENE, cfg.config_name, str(tmp_path / "od"),
               prediction_root=str(tmp_path / "pred"), top_k_repre=cfg.num_representative_masks)
    name = os.path.join(cfg.config_name + "_class_agnostic", f"{SCENE}.npz")
    _npz_equal(os.path.join(root, "prediction", name), str(tmp_path / "pred" / name))


def test_streaming_chunk_cli_equals_jax(scene_pack, stream4, tmp_path):
    """``--streaming-chunk 4`` on the scan on disk, with the test's knobs in
    a JSON config file (``--config <path>``), against the JAX stream's
    artifacts written by the JAX writer."""
    import json

    from maskclustering_tpu.models.postprocess import export_artifacts as jax_export

    root = scene_pack["root"]
    name = "streamcli" + stream4["count_dtype"]
    cfg = _cfg(root, count_dtype=stream4["count_dtype"])
    raw = {k: v for k, v in dataclasses.asdict(cfg).items()
           if k not in ("config_name", "data_root")}
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(raw))
    previous = signal.getsignal(signal.SIGTERM)
    try:
        assert main(["--config", str(path), "--data_root", root, "--seq_name_list", SCENE,
                     "--steps", "cluster", "--streaming-chunk", "4", "--no-journal",
                     "--no-resume", "--device", "cpu"]) == 0
    finally:
        signal.signal(signal.SIGTERM, previous)
        faults.clear_stop()
    jax_export(stream4["jax_result"].objects, SCENE, name, str(tmp_path / "od"),
               prediction_root=str(tmp_path / "pred"), top_k_repre=cfg.num_representative_masks)
    npz = os.path.join(name + "_class_agnostic", f"{SCENE}.npz")
    _npz_equal(os.path.join(root, "prediction", npz), str(tmp_path / "pred" / npz))


# ---------------------------------------------------------------------------
# the configuration refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(streaming_chunk=4, mesh_shape=(1, 2)),
    dict(streaming_chunk=4, use_exact_ball_query=True),
    dict(stream_recluster_every=0),
    dict(stream_mask_headroom=0.99),
    dict(stream_chunk_retries=-1),
    dict(stream_journal_every=-1),
], ids=["mesh", "exact", "recluster_every", "headroom", "retries", "journal_every"])
def test_streaming_config_refusals_equal_jax(kw):
    from maskclustering_tpu_torch.config import load_config

    with pytest.raises(ValueError) as want:
        jax_load_config("scannet", **kw)
    with pytest.raises(ValueError) as got:
        load_config("scannet", **kw)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError):
        streaming.StreamAccumulator(_cfg("."), total_frames=4, num_points=10, device="cpu")
