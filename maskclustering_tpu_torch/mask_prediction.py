"""L2 2D mask prediction: pluggable predictors + the id-map PNG contract
(``mask_prediction.py``).

The reference's mask_predict.py is a detectron2/CropFormer demo script that
writes one id-map PNG per frame: masks with confidence >= 0.5 and >= 400
pixels, numbered 1..K in ascending confidence order so higher-confidence
masks overwrite lower ones (reference mask_predict.py:94-114). That PNG is
the entire L2 -> L3 interface, which makes the predictor itself
pluggable: anything that returns (masks, scores) per image can feed the
pipeline.

In the port:

- `rasterize_id_map` turns (K,H,W) masks + scores into the id-map with a
  per-pixel max of ``id * mask`` (ids ascend with confidence, so "later
  overwrites earlier" is the max), as torch on the masks' device.
- `predict_scene_masks` runs any predictor over a scene's frames and
  writes `<scene>/output/mask/<frame>.png` with the JAX writer's bytes.
- `GridSegmenter` is the dependency-free fallback predictor (colour
  quantisation + connected components), run as torch on the card unless
  the caller asks for the CPU. All of it is integer, so its labels equal
  the JAX module's numpy ones on either device.
- `TorchCropFormerPredictor` adapts a detectron2/CropFormer checkpoint
  when those packages are installed; it is import-gated and never required.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Protocol, Sequence, Tuple

import numpy as np
import torch

from maskclustering_tpu_torch.device import DeviceLike, resolve_device
from maskclustering_tpu_torch.io.image import write_mask_png

CONFIDENCE_THRESHOLD = 0.5  # reference mask_predict.py confidence flag default
MIN_MASK_PIXELS = 400  # reference mask_predict.py:109
# masks a step of the id-map's running max: bounds the (chunk, H, W) int32
# product a step holds (~0.3 GB at 968x1296)
_RASTER_CHUNK = 64


class MaskPredictor(Protocol):
    """Any per-image instance segmenter: rgb (H,W,3) -> (masks, scores)."""

    def __call__(self, rgb: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Returns ((K,H,W) bool masks, numpy or torch, and (K,) float scores)."""
        ...


def rasterize_id_map(
    masks,
    scores,
    confidence_threshold: float = CONFIDENCE_THRESHOLD,
    min_pixels: int = MIN_MASK_PIXELS,
) -> np.ndarray:
    """(K,H,W) masks + (K,) scores -> id-map array (0 = background).

    Reference semantics (mask_predict.py:96-114): drop masks below the
    confidence threshold, iterate the rest in ascending score order
    assigning ids 1..K (sub-400-pixel masks are skipped and consume no
    id), each mask overwriting previously written pixels. Ids ascend with
    confidence, so the overwrite loop is a per-pixel max of ``id_k *
    mask_k``, computed on the masks' device (a torch tensor's, else the
    CPU) and returned as a host array. Scores and the order stay on the host.
    """
    m = masks if isinstance(masks, torch.Tensor) else torch.as_tensor(np.asarray(masks))
    scores = np.asarray(scores.cpu() if isinstance(scores, torch.Tensor) else scores)
    if m.ndim != 3:
        raise ValueError(f"masks must be (K,H,W), got {tuple(m.shape)}")
    h, w = m.shape[1:]
    keep = np.nonzero(scores >= confidence_threshold)[0]
    m, scores = m[torch.as_tensor(keep, device=m.device)], scores[keep]
    if len(m):
        sizes = m.reshape(len(m), -1).sum(dim=1).cpu().numpy()
        big = np.nonzero(sizes >= min_pixels)[0]
        m, scores = m[torch.as_tensor(big, device=m.device)], scores[big]
    if len(m) == 0:
        return np.zeros((h, w), dtype=np.uint8)
    order = np.argsort(scores, kind="stable")
    ids = np.empty(len(m), dtype=np.int64)
    ids[order] = np.arange(1, len(m) + 1)
    ids_t = torch.as_tensor(ids, dtype=torch.int32, device=m.device)
    id_map = torch.zeros((h, w), dtype=torch.int32, device=m.device)
    for k in range(0, len(m), _RASTER_CHUNK):
        part = m[k:k + _RASTER_CHUNK].to(torch.int32) * ids_t[k:k + _RASTER_CHUNK, None, None]
        id_map = torch.maximum(id_map, part.amax(dim=0))
    dtype = np.uint16 if len(m) > 255 else np.uint8
    return id_map.cpu().numpy().astype(dtype)


def predict_scene_masks(
    dataset,
    predictor: MaskPredictor,
    stride: int = 1,
    output_dir: Optional[str] = None,
    resume: bool = True,
    confidence_threshold: float = CONFIDENCE_THRESHOLD,
    min_pixels: int = MIN_MASK_PIXELS,
    progress: Optional[Callable[[str], None]] = None,
) -> List[str]:
    """Run a predictor over a scene's frames; write id-map PNGs.

    Writes each frame's PNG at the exact path the dataset will read it
    back from (``get_frame_path``'s segmentation slot — the name scheme is
    per-dataset, e.g. ScanNet++ uses ``frame_NNNNNN.png``); output_dir
    overrides the directory with plain ``<frame_id>.png`` names. Returns
    the list of written paths; resume skips existing PNGs.
    """
    use_frame_path = output_dir is None and hasattr(dataset, "get_frame_path")
    out_dir = output_dir or dataset.segmentation_dir
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for frame_id in dataset.get_frame_list(stride):
        if use_frame_path:
            path = dataset.get_frame_path(frame_id)[1]
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        else:
            path = os.path.join(out_dir, f"{frame_id}.png")
        if resume and os.path.exists(path):
            continue
        rgb = dataset.get_rgb(frame_id)
        masks, scores = predictor(rgb)
        id_map = rasterize_id_map(masks, scores, confidence_threshold, min_pixels)
        if id_map.size == 0:
            id_map = np.zeros(rgb.shape[:2], dtype=np.uint8)
        write_mask_png(path, id_map)
        written.append(path)
        if progress is not None:
            progress(path)
    return written


# ---------------------------------------------------------------------------
# Fallback predictor: color-quantised connected components (no deps)


@dataclass
class GridSegmenter:
    """Zero-dependency segmenter: color quantisation + 4-connected CCs.

    Not a learned model — a deterministic stand-in that produces
    plausible region masks from RGB alone, used by the demo path and
    tests when no CropFormer checkpoint exists. Confidence is a
    deterministic function of region size so the id-map ordering is
    stable. Runs on ``device`` (``None``: the card, raising without one);
    returns the masks on that device and the scores on the host.
    """

    quant: int = 48  # color quantisation step (uint8 units)
    min_region: int = 64  # pre-filter; rasterize applies MIN_MASK_PIXELS
    device: DeviceLike = None
    # sweeps of the last frame's connected components
    last_sweeps: int = field(default=0, init=False, compare=False)

    def __post_init__(self):
        self._device = resolve_device(self.device)
        if self._device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("GridSegmenter on cuda: no CUDA device is available")

    def __call__(self, rgb: np.ndarray) -> Tuple[torch.Tensor, np.ndarray]:
        rgb = torch.as_tensor(np.ascontiguousarray(rgb)).to(self._device)
        h, w = rgb.shape[:2]
        q = rgb.to(torch.int32) // self.quant
        # base-256 packing is collision-free for any quant >= 1
        key = q[..., 0] * 65536 + q[..., 1] * 256 + q[..., 2]
        labels, self.last_sweeps = _connected_components(key, return_sweeps=True)
        # the labels are 0..n-1 (the unique inverse), so ids = arange(n)
        counts = torch.bincount(labels.reshape(-1))
        keep = torch.nonzero(counts >= self.min_region).reshape(-1)
        masks = labels[None] == keep[:, None, None]
        # larger regions -> higher confidence, capped below 1.0 (host float64)
        sizes = counts[keep].cpu().numpy()
        scores = 0.5 + 0.5 * sizes / (h * w + 1.0)
        return masks, scores.astype(np.float32)


def _connected_components(key, return_sweeps: bool = False):
    """4-connected components of equal-valued pixels, as torch on the
    key's device (a numpy key runs on the CPU).

    Min-label propagation with pointer jumping (``mask_prediction.py:
    161-193``), sweep for sweep: each pixel takes the least old label of
    itself and its equal neighbours, then two jumps to its label's label;
    the fixpoint test is the one host sync a sweep. The final labels are
    the unique inverse, 0..n-1 in order of each component's least pixel.
    """
    key = torch.as_tensor(key)
    h, w = key.shape
    labels = torch.arange(h * w, dtype=torch.int64, device=key.device).reshape(h, w)
    same_r = key[:, :-1] == key[:, 1:]
    same_d = key[:-1, :] == key[1:, :]
    sweeps = 0
    while True:
        sweeps += 1
        lab = labels.clone()
        # min over 4-neighbors with equal keys, each against its OLD label
        lab[:, 1:] = torch.where(same_r, torch.minimum(lab[:, 1:], labels[:, :-1]), lab[:, 1:])
        lab[:, :-1] = torch.where(same_r, torch.minimum(lab[:, :-1], labels[:, 1:]), lab[:, :-1])
        lab[1:, :] = torch.where(same_d, torch.minimum(lab[1:, :], labels[:-1, :]), lab[1:, :])
        lab[:-1, :] = torch.where(same_d, torch.minimum(lab[:-1, :], labels[1:, :]), lab[:-1, :])
        # pointer jumping: chase each label to its current representative
        flat = lab.reshape(-1)
        flat = torch.minimum(flat, flat[flat])
        flat = torch.minimum(flat, flat[flat])
        new = flat.reshape(h, w)
        if torch.equal(new, labels):
            break
        labels = new
    _, out = torch.unique(new, sorted=True, return_inverse=True)
    out = out.reshape(h, w)
    return (out, sweeps) if return_sweeps else out


def predictor_from_spec(spec: str, device: DeviceLike = None) -> "MaskPredictor":
    """Mask-predictor factory for config-driven construction.

    ``"grid"`` -> GridSegmenter on ``device`` (dependency-free fallback);
    ``"<detectron2 yaml>::<checkpoint.pth>"`` -> TorchCropFormerPredictor
    (the reference's cropformer_path carries the checkpoint,
    configs/scannet.json:8; the yaml names the architecture).
    """
    if spec == "grid":
        return GridSegmenter(device=device)
    if "::" in spec:
        config_file, _, checkpoint = spec.partition("::")
        return TorchCropFormerPredictor(config_file, checkpoint)
    raise ValueError(
        f"unknown mask-predictor spec {spec!r}: use 'grid' or "
        f"'<config.yaml>::<checkpoint.pth>'")


# ---------------------------------------------------------------------------
# Optional torch/detectron2 CropFormer adapter (import-gated)


class TorchCropFormerPredictor:
    """Adapter around a detectron2/CropFormer demo pipeline.

    The reference runs CropFormer through detectron2's VisualizationDemo
    (mask_predict.py:16-21,78,91). Those packages ship CUDA kernels and
    are not part of this framework; when they are installed alongside it,
    this adapter exposes the checkpoint through the MaskPredictor
    interface. Instantiating without them raises a clear ImportError.
    """

    def __init__(self, config_file: str, checkpoint_path: str,
                 opts: Sequence[str] = ()):
        try:
            from detectron2.config import get_cfg  # type: ignore
            from detectron2.projects.deeplab import add_deeplab_config  # type: ignore
            from demo_cropformer.predictor import VisualizationDemo  # type: ignore
        except ImportError as e:  # pragma: no cover - gated dependency
            raise ImportError(
                "TorchCropFormerPredictor needs detectron2 + CropFormer "
                "(see the reference dockerfile); install them or use "
                "precomputed mask PNGs / GridSegmenter instead") from e
        cfg = get_cfg()
        add_deeplab_config(cfg)
        cfg.merge_from_file(config_file)
        cfg.merge_from_list(list(opts) + ["MODEL.WEIGHTS", checkpoint_path])
        cfg.freeze()
        self._demo = VisualizationDemo(cfg)

    def __call__(self, rgb: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        bgr = np.asarray(rgb)[..., ::-1]
        predictions = self._demo.run_on_image(bgr)
        inst = predictions["instances"]
        return (inst.pred_masks.cpu().numpy().astype(bool),
                inst.scores.cpu().numpy())
