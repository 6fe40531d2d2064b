"""One-command demo with zero downloads (``scripts/demo.py:30-120``).

The reference's fast demo needs a 1 GB download (a ScanNet scene and its
CropFormer masks) before it can run. This writes a ray-traced synthetic
scene in the on-disk ScanNet layout instead (colour, depth, poses,
intrinsics, id-maps, the ``vh_clean_2.ply`` cloud and its ground truth),
then runs the pipeline a real run uses (``run.run_pipeline``) over nine steps: clustering,
class-agnostic export and AP against the scene's ground truth, the
open-vocabulary steps on the hash encoder, the scene visualiser and the
per-object top images. It prints where every artifact landed.

    python -m maskclustering_tpu_torch.demo                # on the CUDA card
    python -m maskclustering_tpu_torch.demo --device cpu   # on the CPU

Everything is written under ``--out`` (default ``./output/demo_data``); a
second run reuses the scene and resumes from its artifacts, and a run
whose scene options differ from the stamped ones exits 2. Exit 0 when
every step succeeded, 1 otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

STEPS = ("masks", "cluster", "eval_ca", "features", "label_features", "query", "eval", "vis",
         "top_images")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="./output/demo_data",
                   help="data_root for the generated scene + all artifacts")
    p.add_argument("--seq", default="demo0001_00")
    p.add_argument("--frames", type=int, default=32)
    p.add_argument("--objects", type=int, default=6)
    p.add_argument("--image-h", type=int, default=240)
    p.add_argument("--image-w", type=int, default=320)
    p.add_argument("--device", default=None,
                   help="torch device (e.g. cpu); default = the current CUDA card")
    args = p.parse_args(argv)

    from maskclustering_tpu_torch.device import resolve_device

    device = resolve_device(args.device)

    from maskclustering_tpu_torch.config import load_config
    from maskclustering_tpu_torch.run import run_pipeline
    from maskclustering_tpu_torch.utils.synthetic import make_scene, write_scannet_layout

    data_root = os.path.abspath(args.out)
    scene_dir = os.path.join(data_root, "scannet", "processed", args.seq)
    gen_params = {"frames": args.frames, "objects": args.objects,
                  "image_h": args.image_h, "image_w": args.image_w}
    meta_path = os.path.join(scene_dir, "demo_scene_meta.json")
    if os.path.isdir(scene_dir):
        stamped = None
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                stamped = json.load(f)
        if stamped != gen_params:
            print(f"[demo] ERROR: {scene_dir} holds a scene generated with "
                  f"{stamped}, but this run asked for {gen_params}.\n"
                  f"[demo] pick a different --out or delete that directory "
                  f"to regenerate.", file=sys.stderr)
            return 2
        print(f"[demo] reusing generated scene at {scene_dir}")
    else:
        print(f"[demo] generating a {args.frames}-frame synthetic scene "
              f"({args.objects} objects) ...")
        scene = make_scene(num_boxes=args.objects, num_frames=args.frames,
                           image_hw=(args.image_h, args.image_w), seed=608)
        write_scannet_layout(scene, data_root, args.seq)
        with open(meta_path, "w") as f:
            json.dump(gen_params, f)
        print(f"[demo] wrote ScanNet-layout scene to {scene_dir}")

    cfg = load_config("scannet").replace(
        config_name="demo", data_root=data_root, step=1,
        distance_threshold=0.03, mask_pad_multiple=64)

    t0 = time.time()
    report = run_pipeline(cfg, [args.seq], steps=STEPS, encoder_spec="hash:64",
                          report_path=os.path.join(data_root, "report.json"), device=device)
    dt = time.time() - t0

    scene_status = report.scenes[0] if report.scenes else None
    n_obj = scene_status.num_objects if scene_status else 0
    print(f"\n[demo] pipeline finished in {dt:.1f}s; "
          f"{n_obj} objects recovered (planted: {args.objects})")
    for name, secs in report.step_seconds.items():
        err = " FAILED" if name in report.step_errors else ""
        print(f"[demo]   step {name:<14} {secs:6.1f}s{err}")

    print("[demo] artifacts:")
    for rel in artifacts(args.seq):
        path = os.path.join(data_root, rel)
        mark = "ok" if os.path.exists(path) else "MISSING"
        print(f"[demo]   [{mark:^7}] {path}")

    eval_txt = os.path.join(data_root, "evaluation", "scannet", "demo_class_agnostic.txt")
    if os.path.exists(eval_txt):
        with open(eval_txt) as f:
            lines = [ln.rstrip() for ln in f if ln.strip()]
        print("[demo] class-agnostic AP vs the generated GT "
              "(non-nan classes + average):")
        for ln in lines:
            if "nan" not in ln:
                print(f"[demo]   {ln}")
    return 0 if report.ok else 1


def artifacts(seq: str):
    """The artifacts the demo lists, relative to ``--out``
    (``scripts/demo.py:100-106``)."""
    return (f"prediction/demo_class_agnostic/{seq}.npz",
            f"scannet/processed/{seq}/output/object/demo/object_dict.npy",
            "evaluation/scannet/demo_class_agnostic.txt",
            f"vis/{seq}/instances.ply",
            f"vis/{seq}/top_images/grid",
            "report.json")


if __name__ == "__main__":
    sys.exit(main())
