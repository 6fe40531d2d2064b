"""Dense-vs-exact association A/B at the reference thresholds (the port's
``scripts/parity_ab.py``).

The default projective association (``models/backprojection.py``)
reformulates the reference's ball-query pipeline (search direction
inverted, voxel-count coverage denominator, window-limited claiming). This
harness measures what that costs at the reference's own operating point
(``distance_threshold`` = 0.01 m, reference utils/mask_backprojection.py:10)
on noisy synthetic RGB-D at ScanNet-like density:

- both association paths run through the full pipeline (graph ->
  clustering -> post-process -> npz export) on the same scenes; the exact
  path launches the ball-query kernel (``ops/cuda/ball_query.cu``) on the
  card;
- class-agnostic AP of each against the synthetic GT;
- Jaccard of the per-mask claimed point sets between the paths.

The markdown goes to ``--out`` (default under ``build/tools/``, never a
tracked file) and stdout; exit 0 when every operating point passes both
bounds::

    python -m maskclustering_tpu_torch.tools.parity_ab [--points shallow,deep] [--device cpu]

On the card unless ``--device`` names another device; asked for the card on
a host without one, it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import List, Optional

import numpy as np

DEFAULT_OUT = os.path.join("build", "tools", "PARITY.md")
# the device post-process's DBSCAN neighbour cap: at this density the
# config's 256 overflows (PostprocessCapacityError on the shallow point's
# first scene, dense and exact, in the JAX package's device post-process on
# the CPU as in this one); the cap bounds only the packing, no value
# depends on it
NEIGHBOR_CAP = 1024


def mask_sets_from_association(assoc, k_max):
    """{(frame, id): sorted point ids} from a SceneAssociation's claims."""
    first, last, valid = (x.cpu().numpy() for x in (assoc.first_id, assoc.last_id,
                                                     assoc.mask_valid))
    sets = {}
    for f in range(first.shape[0]):
        for arr in (first, last):
            ids = arr[f]
            for mid in np.unique(ids):
                if mid <= 0 or mid > k_max or not valid[f, mid]:
                    continue
                pts = np.nonzero(ids == mid)[0]
                key = (f, int(mid))
                sets[key] = np.union1d(sets[key], pts) if key in sets else pts
    return sets


def jaccard_stats(sets_a, sets_b):
    """(mean, median, common masks, a-only, b-only) of the per-mask Jaccard."""
    keys = sorted(set(sets_a) | set(sets_b))
    vals = []
    only_a = only_b = 0
    for k in keys:
        if k not in sets_a:
            only_b += 1
            continue
        if k not in sets_b:
            only_a += 1
            continue
        a, b = sets_a[k], sets_b[k]
        inter = np.intersect1d(a, b).size
        union = np.union1d(a, b).size
        vals.append(inter / max(union, 1))
    return (float(np.mean(vals)) if vals else 0.0,
            float(np.median(vals)) if vals else 0.0, len(vals), only_a, only_b)


# "shallow" = the original configuration; "deep" = real schedule depth, where
# the observer-percentile ladder (reference graph/construction.py:80-96)
# walks its full 95->0 range; "full" = half a real ScanNet scene's schedule
# depth at the honest mask budget, run on demand
OPERATING_POINTS = {
    "shallow": dict(scenes=3, frames=16, boxes=4, k_max=15),
    "deep": dict(scenes=2, frames=64, boxes=16, k_max=31),
    "full": dict(scenes=1, frames=128, boxes=24, k_max=63),
}


def run_point(point_name, pt, args, device):
    """Run one operating point -> (rows, ap_dense, ap_exact)."""
    from maskclustering_tpu_torch.config import PipelineConfig
    from maskclustering_tpu_torch.evaluation.ap import evaluate_scans
    from maskclustering_tpu_torch.models.backprojection import associate_scene_tensors
    from maskclustering_tpu_torch.models.exact_backprojection import associate_scene_exact
    from maskclustering_tpu_torch.models.pipeline import run_scene
    from maskclustering_tpu_torch.utils.synthetic import make_scene, to_scene_tensors

    # the reference operating point (utils/mask_backprojection.py:8-14 + configs)
    cfg = PipelineConfig(config_name=f"parity_{point_name}", dataset="demo",
                         distance_threshold=0.01, few_points_threshold=25,
                         coverage_threshold=0.3, point_chunk=8192,
                         post_neighbor_cap=NEIGHBOR_CAP)
    k_max = pt["k_max"]
    # the npz exports and GT files live only as long as the point's run
    with tempfile.TemporaryDirectory(prefix=f"parity_{point_name}_") as workdir:
        gt_files, dense_npz, exact_npz = [], [], []
        rows = []
        for s in range(pt["scenes"]):
            rng = np.random.default_rng(1000 + s)
            scene = make_scene(num_boxes=pt["boxes"], num_frames=pt["frames"],
                               image_hw=(args.image_h, args.image_w), spacing=args.spacing,
                               floor_spacing=args.floor_spacing, seed=100 + s)
            noisy = scene.depths + rng.normal(scale=args.noise,
                                              size=scene.depths.shape).astype(np.float32)
            scene.depths[:] = np.where(scene.depths > 0, np.maximum(noisy, 1e-3), 0.0)
            tensors = to_scene_tensors(scene)
            n_pts = tensors.num_points
            print(f"[parity:{point_name}] scene {s}: {n_pts} points, {pt['frames']} frames",
                  file=sys.stderr, flush=True)

            t0 = time.time()
            sets_dense = mask_sets_from_association(
                associate_scene_tensors(tensors, cfg, k_max=k_max, device=device), k_max)
            t_dense = time.time() - t0
            t0 = time.time()
            sets_exact = mask_sets_from_association(
                associate_scene_exact(tensors, cfg, k_max=k_max, device=device), k_max)
            t_exact = time.time() - t0

            jac_mean, jac_med, n_common, only_d, only_e = jaccard_stats(sets_dense, sets_exact)
            rows.append((s, n_pts, jac_mean, jac_med, n_common, only_d, only_e, t_dense, t_exact))
            print(f"[parity:{point_name}] scene {s}: mask Jaccard mean={jac_mean:.3f} "
                  f"median={jac_med:.3f} common={n_common} dense-only={only_d} "
                  f"exact-only={only_e} ({t_dense:.0f}s vs {t_exact:.0f}s)",
                  file=sys.stderr, flush=True)

            for name, use_exact, bucket in (("dense", False, dense_npz),
                                            ("exact", True, exact_npz)):
                res = run_scene(tensors, cfg.replace(config_name=f"parity_{point_name}_{name}",
                                                     use_exact_ball_query=use_exact),
                                k_max=k_max, seq_name=f"scene{s:04d}_00", export=True,
                                object_dict_dir=os.path.join(workdir, name, f"scene{s:04d}_00"),
                                prediction_root=os.path.join(workdir, "prediction"),
                                device=device)
                bucket.append(os.path.join(workdir, "prediction",
                                           f"parity_{point_name}_{name}_class_agnostic",
                                           f"scene{s:04d}_00.npz"))
                print(f"[parity:{point_name}] scene {s} {name}: "
                      f"{len(res.objects.point_ids_list)} objects", file=sys.stderr, flush=True)

            gt = np.where(scene.gt_instance > 0, 3000 + scene.gt_instance + 1, 1)
            gt_path = os.path.join(workdir, f"scene{s:04d}_00.txt")
            np.savetxt(gt_path, gt, fmt="%d")
            gt_files.append(gt_path)

        ap_dense = evaluate_scans(dense_npz, gt_files, "scannet", no_class=True, verbose=False,
                                  device=device)
        ap_exact = evaluate_scans(exact_npz, gt_files, "scannet", no_class=True, verbose=False,
                                  device=device)
    return rows, ap_dense, ap_exact


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="python -m maskclustering_tpu_torch.tools.parity_ab")
    p.add_argument("--spacing", type=float, default=0.008)
    p.add_argument("--floor-spacing", type=float, default=0.016)
    p.add_argument("--noise", type=float, default=0.002, help="depth noise sigma (m)")
    # 480x640 = ScanNet depth size; at r = 0.01 the pixel grid must be finer
    # than the radius or neither path can claim (pixel 3D spacing ~5 mm at 3 m)
    p.add_argument("--image-h", type=int, default=480)
    p.add_argument("--image-w", type=int, default=640)
    p.add_argument("--ap50-bound", type=float, default=0.05,
                   help="max |AP50 gap| per operating point for PASS (exit 0)")
    p.add_argument("--jaccard-bound", type=float, default=0.85,
                   help="min per-scene mean mask Jaccard for PASS")
    p.add_argument("--points", default="shallow,deep",
                   help="comma-separated operating points to run")
    p.add_argument("--scenes", type=int, default=None,
                   help="scenes a point (default: the operating point's own count)")
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' for the plain path)")
    args = p.parse_args(argv)

    from maskclustering_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    lines = [
        "# PARITY — dense projective association vs reference ball-query path (PyTorch/CUDA port)",
        "",
        "A/B at the REFERENCE thresholds: distance_threshold = 0.01 m",
        "(utils/mask_backprojection.py:10), synthetic scenes at ScanNet-like",
        f"density (spacing {args.spacing} m), {args.image_h}x{args.image_w} depth",
        f"frames with sigma = {args.noise * 1000:.0f} mm Gaussian noise.",
        "Both paths run the full pipeline to npz; generated by",
        f"`python -m maskclustering_tpu_torch.tools.parity_ab` on {dev.type} (deterministic",
        "seeds). *shallow* is 16 fr x 4 obj; *deep* 64 fr x 16 obj + floor, k_max 31: at",
        "depth the observer-percentile schedule (reference graph/construction.py:80-96)",
        "walks its full 95->0 ladder and undersegment/containment dynamics engage.",
        "",
    ]
    verdicts = []
    for point_name in args.points.split(","):
        pt = OPERATING_POINTS[point_name]
        if args.scenes is not None:
            pt = dict(pt, scenes=args.scenes)
        t0 = time.time()
        rows, ap_dense, ap_exact = run_point(point_name, pt, args, dev)
        elapsed = time.time() - t0

        def _ap3(res):
            return res["all_ap"], res["all_ap_50%"], res["all_ap_25%"]

        d_ap, d_ap50, d_ap25 = _ap3(ap_dense)
        e_ap, e_ap50, e_ap25 = _ap3(ap_exact)
        jms = [r[2] for r in rows]
        ap_ok = abs(d_ap50 - e_ap50) <= args.ap50_bound
        jac_ok = float(np.min(jms)) >= args.jaccard_bound
        verdicts.append((point_name, ap_ok and jac_ok, abs(d_ap50 - e_ap50), float(np.min(jms))))
        lines += [
            f"## Operating point: {point_name} — {pt['scenes']} scenes x "
            f"{pt['frames']} frames x {pt['boxes']} objects (k_max {pt['k_max']})",
            "",
            "### Class-agnostic AP vs synthetic GT",
            "",
            "| path | AP | AP50 | AP25 |",
            "|---|---|---|---|",
            f"| dense (flagship) | {d_ap:.4f} | {d_ap50:.4f} | {d_ap25:.4f} |",
            f"| exact (reference semantics) | {e_ap:.4f} | {e_ap50:.4f} | {e_ap25:.4f} |",
            f"| **gap (dense - exact)** | {d_ap - e_ap:+.4f} | "
            f"{d_ap50 - e_ap50:+.4f} | {d_ap25 - e_ap25:+.4f} |",
            "",
            "### Per-mask claimed-point-set Jaccard (dense vs exact)",
            "",
            "| scene | points | mean J | median J | common masks | dense-only | exact-only |",
            "|---|---|---|---|---|---|---|",
        ]
        for s, n_pts, jm, jmed, nc, od, oe, td, te in rows:
            lines.append(f"| {s} | {n_pts} | {jm:.3f} | {jmed:.3f} | {nc} | {od} | {oe} |")
        lines += [
            "",
            f"Aggregate mask-set Jaccard: mean {np.mean(jms):.3f} (min scene "
            f"{np.min(jms):.3f}). Point completed in {elapsed / 60:.0f} min.",
            "",
        ]
    lines += [
        "## Bound and verdict",
        "",
        f"Pass criterion per operating point: |AP50 gap| <= {args.ap50_bound:.2f}"
        f" and per-scene mean mask Jaccard >= {args.jaccard_bound:.2f}.",
        "",
        "| point | AP50 gap | min mean Jaccard | verdict |",
        "|---|---|---|---|",
    ]
    for name, ok, gap, jmin in verdicts:
        lines.append(f"| {name} | {gap:.4f} | {jmin:.3f} | {'PASS' if ok else 'FAIL'} |")
    all_ok = all(ok for _, ok, _, _ in verdicts)
    lines += [
        "",
        "The two association paths stay selectable per run via",
        "`use_exact_ball_query` for real-data validation.",
        "",
        f"**Overall: {'PASS' if all_ok else 'FAIL'}**",
        "",
    ]
    out_dir = os.path.dirname(args.out)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    with open(args.out, "w") as fh:
        fh.write("\n".join(lines))
    from maskclustering_tpu_torch.ops.cuda import LAUNCHES

    # the exact path's ball queries run on the card through the kernel
    print(f"[parity] wrote {args.out}; kernel launches "
          f"{json.dumps(dict(sorted(LAUNCHES.counts.items())))}", file=sys.stderr)
    print("\n".join(lines))
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main())
