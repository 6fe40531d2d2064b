"""The port's CUDA kernels built and launched from several threads at once.

A serving daemon launches kernels from its worker thread and from its
canary thread, and the batch driver's overlapped executor from two
threads; the plain torch versions run on the card beside them. Here, from
an empty build directory, one thread runs the plain ball query on the card
while three others build and launch the association kernels and the three
splat entries (two of them the splats, as the worker and the canary
would), each result held against its plain version. The library loads
under ``ops.cuda._LOAD_LOCK``, the launch log and the build hooks are what
it exercises. It needs the card and skips without one; run it there
alone, repeatedly, each run in a process of its own:

    for i in $(seq 20); do python -m pytest -m gpu --noconftest -q \\
        tests/test_torch_cuda_threads.py || break; done
"""

import threading

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs in parallel worker processes
torch.set_num_threads(1)


def _ball_queries(dev, stop, errors):
    from maskclustering_tpu_torch.ops.neighbor import ball_query_reference
    from maskclustering_tpu_torch.ops.neighbor_cases import BALL_QUERY_CASES, ball_query_case

    cases = [ball_query_case(name) for name in BALL_QUERY_CASES]
    want = [ball_query_reference(*[torch.from_numpy(a) for a in c[:4]], k=c[4], radius=c[5])
            for c in cases]
    while not stop.is_set():
        for (q, c, ql, cl, k, r), w in zip(cases, want):
            got = ball_query_reference(*[torch.from_numpy(a).to(dev) for a in (q, c, ql, cl)],
                                       k=k, radius=r)
            if not torch.equal(got.cpu(), w):
                errors.append("the plain ball query on the card differs from the cpu's")
                return


def _associations(dev, errors):
    from maskclustering_tpu_torch.models import backprojection as bp
    from maskclustering_tpu_torch.ops import cuda as kernels
    from maskclustering_tpu_torch.ops.association_cases import (
        SCENE_CASES,
        association_scene_case,
    )
    from maskclustering_tpu_torch.ops.geometry import invert_se3

    for name in SCENE_CASES:
        case = association_scene_case(name)
        pts, depths, segs, intr, c2w = (torch.from_numpy(np.asarray(case[k])).to(dev) for k in (
            "points", "depths", "segs", "intrinsics", "cam_to_world"))
        prm = bp.claim_params(intr, invert_se3(c2w), distance_threshold=case["distance_threshold"],
                              depth_trunc=case["depth_trunc"])
        k_max, window = case["k_max"], case["window"]
        table = kernels.associate_table_cuda(depths, segs, prm, k_max=k_max)
        n = kernels.associate_claim_scene_cuda(pts, table, prm, k_max=k_max, window=window)
        valid = torch.ones((depths.shape[0], k_max + 1), dtype=torch.bool, device=dev)
        got = kernels.associate_assign_scene_cuda(pts, table, prm, valid, k_max=k_max,
                                                  window=window)
        want = (bp.pixel_table_reference(depths, segs, prm, k_max=k_max),
                bp.claim_scene_reference(pts, table, prm, k_max=k_max, window=window),
                *bp.assign_scene_reference(pts, table, prm, valid, k_max=k_max, window=window))
        if not all(torch.equal(g, w) for g, w in zip((table, n, *got), want)):
            errors.append(f"an association kernel differs from its plain version on {name}")


def _splats(dev, errors, names):
    from maskclustering_tpu_torch.ops import cuda as kernels
    from maskclustering_tpu_torch.ops.splat_cases import SPLAT_BATCHES
    from maskclustering_tpu_torch.visualize import top_images as ti

    for name in names:
        b = SPLAT_BATCHES[name]
        h, w = b["height"], b["width"]
        pts, cols = (torch.from_numpy(b[k]).to(dev) for k in ("points", "colors"))
        prm = ti.splat_params(torch.from_numpy(b["intrinsics"]),
                              torch.from_numpy(b["cam_to_world"])).to(dev)
        zb = kernels.splat_depth_cuda(pts, prm, height=h, width=w)
        got = (zb, *kernels.splat_color_cuda(pts, cols, prm, zb, height=h, width=w),
               kernels.splat_bbox_cuda(pts, prm, height=h, width=w))
        zr = ti.splat_depth_reference(pts, prm, h, w)
        want = (zr, *ti.splat_color_reference(pts, cols, prm, zr, h, w),
                ti.splat_bbox_reference(pts, prm, h, w))
        if not all(torch.equal(g, r) for g, r in zip(got, want)):
            errors.append(f"a splat entry differs from its plain version on {name}")


@pytest.mark.gpu
def test_kernels_build_and_launch_from_threads_beside_the_plain_ball_query(tmp_path,
                                                                          monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from maskclustering_tpu_torch.ops import cuda as kernels
    from maskclustering_tpu_torch.ops.splat_cases import SPLAT_BATCHES

    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "torch_kernels"))
    monkeypatch.setattr(kernels, "_LIBS", {})
    built = []
    monkeypatch.setattr(kernels, "BUILD_HOOKS", [lambda name, path: built.append(name)])
    kernels.LAUNCHES.reset()
    dev = torch.device("cuda", 0)
    stop, errors = threading.Event(), []
    names = sorted(SPLAT_BATCHES)

    def guarded(fn, *args):
        def run():
            try:
                fn(*args)
            except Exception as e:  # noqa: BLE001 — reported by the test
                errors.append(f"{fn.__name__}: {type(e).__name__}: {e}")
        return threading.Thread(target=run)

    plain = guarded(_ball_queries, dev, stop, errors)
    launching = [guarded(_associations, dev, errors), guarded(_splats, dev, errors, names),
                 guarded(_splats, dev, errors, names[::-1])]
    plain.start()
    for t in launching:
        t.start()
    for t in launching:
        t.join(600)
    stop.set()
    plain.join(600)
    torch.cuda.synchronize()
    assert not errors, errors
    assert sorted(built) == ["associate", "splat"]
    counts = kernels.LAUNCHES.counts
    assert counts["splat_depth"] == counts["splat_color"] == counts["splat_bbox"] == 2 * len(names)
    assert counts["associate_table"] == counts["associate_claim"] == counts["associate_assign"] > 0
