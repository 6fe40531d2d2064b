"""Frame-batch identity of the association on the card, and the card's
association against the CPU's (the port's ``scripts/fb_identity.py``).

The JAX package's ``association_frame_batch`` sets how many frames a step
of its batched map takes and must change no value. The port associates
every frame of a call in one launch of each kernel, so the knob has no
counterpart in ``associate_scene`` (``models/backprojection.py:540-543``);
this tool holds the same identity by associating the scene one frame a
call (``frame_batch=1``) and ``--frame-batch`` frames a call, with the
whole cloud's coverage voxel, and comparing every field of the two
``SceneAssociation``s. On the card it then associates the same
device-rendered scene on the CPU and compares it with the card's: the
cross-backend identity the JAX tool's docstring asks for. One verdict
line::

    python -m maskclustering_tpu_torch.tools.fb_identity [--frame-batch 8] [--device cpu]

Exit 0 = identical, 1 = a mismatch (the first differing field), 2 = the
device could not be used.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

FIELDS = ("mask_of_point", "first_id", "last_id", "point_visible", "boundary", "mask_valid")


def associate_frame_batches(tensors, cfg, *, k_max: int, frame_batch: int, device):
    """The scene's association, ``frame_batch`` frames a call, with the
    whole cloud's coverage voxel: {field: CPU tensor}, the per-frame fields
    concatenated along the frame axis and ``boundary`` or-ed."""
    import torch

    from maskclustering_tpu_torch.models.backprojection import (
        _vox_size_jit,
        associate_scene_tensors,
    )
    from maskclustering_tpu_torch.models.streaming import slice_scene_frames

    points = torch.from_numpy(tensors.scene_points).to(device)
    vox = _vox_size_jit(points, distance_threshold=float(cfg.distance_threshold))
    parts = []
    for start in range(0, tensors.num_frames, frame_batch):
        chunk = slice_scene_frames(tensors, start, min(start + frame_batch, tensors.num_frames))
        a = associate_scene_tensors(chunk, cfg, k_max=k_max, device=device, vox_size=vox)
        parts.append({f: getattr(a, f).cpu() for f in FIELDS})
    out = {f: torch.cat([p[f] for p in parts]) for f in FIELDS if f != "boundary"}
    out["boundary"] = torch.stack([p["boundary"] for p in parts]).any(dim=0)
    return out


def first_difference(got, want) -> Optional[str]:
    """The first field (in ``FIELDS`` order) whose tensors differ, with its
    count of differing cells; None when all are equal."""
    for field in FIELDS:
        a, b = got[field], want[field]
        if a.shape != b.shape:
            return f"{field} shapes {tuple(a.shape)} != {tuple(b.shape)}"
        if not bool((a == b).all()):
            return f"{field} differs in {int((a != b).sum())} cells"
    return None


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="python -m maskclustering_tpu_torch.tools.fb_identity")
    p.add_argument("--frames", type=int, default=24)
    p.add_argument("--points", type=int, default=32768)
    p.add_argument("--boxes", type=int, default=6)
    p.add_argument("--frame-batch", type=int, default=8)
    p.add_argument("--k-max", type=int, default=63)
    p.add_argument("--distance-threshold", type=float, default=0.01)
    p.add_argument("--spacing", type=float, default=0.025)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' for the plain path)")
    args = p.parse_args(argv)

    import torch

    from maskclustering_tpu_torch.config import PipelineConfig
    from maskclustering_tpu_torch.device import resolve_device
    from maskclustering_tpu_torch.utils.synthetic import make_scene_device, resize_scene_points

    try:
        dev = resolve_device(args.device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available")
        tensors, _, _ = make_scene_device(num_boxes=args.boxes, num_frames=args.frames,
                                          image_hw=(96, 128), spacing=args.spacing, seed=3,
                                          device=dev)
    except Exception as e:  # noqa: BLE001 — one-line verdict contract
        print(f"[fb_identity] FAIL: device init: {e}", flush=True)
        return 2
    tensors.scene_points = resize_scene_points(tensors.scene_points, args.points)
    cfg = PipelineConfig(config_name="fb_identity", dataset="demo",
                         distance_threshold=args.distance_threshold, few_points_threshold=25,
                         coverage_threshold=0.3, association_window=1)
    kw = dict(k_max=args.k_max)
    seq = associate_frame_batches(tensors, cfg, frame_batch=1, device=dev, **kw)
    bat = associate_frame_batches(tensors, cfg, frame_batch=args.frame_batch, device=dev, **kw)
    diff = first_difference(bat, seq)
    if diff is not None:
        print(f"[fb_identity] FAIL on {dev.type}: {diff} at frame_batch={args.frame_batch}",
              flush=True)
        return 1
    cross = ""
    if dev.type != "cpu":
        host = associate_frame_batches(tensors, cfg, frame_batch=args.frames, device="cpu", **kw)
        diff = first_difference(seq, host)
        if diff is not None:
            print(f"[fb_identity] FAIL: {dev.type} against cpu: {diff}", flush=True)
            return 1
        cross = f"; {dev.type} == cpu on the same frames"
    print(f"[fb_identity] OK: frame_batch={args.frame_batch} byte-identical to sequential on "
          f"device={dev.type} (F={args.frames}, N={args.points}, boxes={args.boxes}){cross}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
