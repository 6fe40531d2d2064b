"""Encoders of the open-vocabulary semantics.

Port of ``maskclustering_tpu/semantics/encoder.py``; features are host
numpy as there:

- ``HashEncoder``: the deterministic stand-in the batch driver uses by
  default (``--encoder hash[:dim]``): a byte-identical crop or text maps to
  the same unit vector, so pooling and the query run without weights;
- ``PrecomputedFeatures``: a store of features computed elsewhere;
- ``HFCLIPEncoder``: CLIP from a checkpoint on disk (``hf:<path>``), in
  plain PyTorch on the caller's device: the towers of ``clip.py``, the
  readers of ``checkpoint.py``, the tokenizer and image processor of
  ``tokenizer.py`` and ``image_processor.py``; none of ``transformers``,
  ``tokenizers``, ``safetensors``, ``msgpack``, ``flax`` or PIL.

Every encoder returns L2-normalised float32 features.
"""

from __future__ import annotations

import glob
import os
import zlib
from typing import Optional, Protocol, Sequence

import numpy as np
import torch

from maskclustering_tpu_torch.device import DeviceLike, check_full_float32, resolve_device
from maskclustering_tpu_torch.semantics.checkpoint import (
    load_clip_checkpoint,
    resolve_checkpoint_dir,
)
from maskclustering_tpu_torch.semantics.clip import CLIP
from maskclustering_tpu_torch.semantics.image_processor import CLIPImageProcessor
from maskclustering_tpu_torch.semantics.tokenizer import CLIPTokenizer


class ImageEncoder(Protocol):
    feature_dim: int

    def encode_images(self, images: Sequence[np.ndarray]) -> np.ndarray:
        """(B, D) L2-normalized features from a list of HxWx3 uint8 images."""
        ...


class TextEncoder(Protocol):
    feature_dim: int

    def encode_texts(self, texts: Sequence[str]) -> np.ndarray:
        """(B, D) L2-normalized features from text prompts."""
        ...


def l2_normalize(x: np.ndarray, axis: int = -1, eps: float = 1e-12) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=axis, keepdims=True), eps)


def find_local_clip_checkpoint(extra_dirs: Sequence[str] = ()) -> Optional[str]:
    """First CLIP checkpoint directory found on local disk, or None.

    Searched: ``MCT_CLIP_PATH``, ``extra_dirs`` and the HuggingFace hub
    cache (model dirs whose name mentions clip). A hit is a directory with
    a config and a weights file, in the HF-transformers layout or the
    open_clip cache layout. The batch driver records the outcome in its
    report (``RunReport.clip_checkpoint``).
    """
    candidates = []
    env = os.environ.get("MCT_CLIP_PATH")
    if env:
        candidates.append(env)
    candidates.extend(extra_dirs)
    hub = os.environ.get(
        "HF_HUB_CACHE", os.path.join(os.path.expanduser("~"), ".cache", "huggingface", "hub"))
    for model_dir in sorted(glob.glob(os.path.join(hub, "models--*"))):
        if "clip" in os.path.basename(model_dir).lower():
            candidates.extend(sorted(glob.glob(os.path.join(model_dir, "snapshots", "*"))))
    config_names = ("config.json", "open_clip_config.json")
    weight_names = ("flax_model.msgpack", "pytorch_model.bin", "model.safetensors",
                    "open_clip_pytorch_model.bin", "open_clip_model.safetensors")
    for cand in candidates:
        if not any(os.path.isfile(os.path.join(cand, c)) for c in config_names):
            continue
        if any(os.path.isfile(os.path.join(cand, w)) for w in weight_names):
            return cand
    return None


class HashEncoder:
    """Deterministic stand-in encoder: feature = seeded hash of the input.

    Images and texts that are bytewise identical map to identical unit
    vectors (numpy's ``default_rng`` seeded with the CRC-32 of the bytes).
    """

    def __init__(self, feature_dim: int = 64):
        self.feature_dim = feature_dim

    def _embed(self, payload: bytes) -> np.ndarray:
        rng = np.random.default_rng(zlib.crc32(payload))
        return rng.standard_normal(self.feature_dim).astype(np.float32)

    def encode_images(self, images: Sequence[np.ndarray]) -> np.ndarray:
        feats = [self._embed(np.ascontiguousarray(im).tobytes()) for im in images]
        return l2_normalize(np.stack(feats))

    def encode_texts(self, texts: Sequence[str]) -> np.ndarray:
        feats = [self._embed(t.encode()) for t in texts]
        return l2_normalize(np.stack(feats))


class HFCLIPEncoder:
    """CLIP from a local checkpoint (``encoder.py:326-405``).

    ``model_name_or_path`` is a directory in the open_clip cache layout (the
    reference's ViT-H-14 ``laion2b_s32b_b79k``), or in the HF layout with
    Flax, safetensors or torch weights, or a repo id in the local hub
    cache; ``checkpoint.load_clip_checkpoint`` reads it in the JAX
    encoder's order. The weights stay on ``device`` (the card unless the
    caller asks for the CPU) and run in float32; a card that would round
    float32 products to TF32 is refused. The tokenizer and preprocessor
    files sit beside the weights. ``image_size`` is accepted for the JAX
    signature; the preprocessor's crop size decides.
    """

    def __init__(self, model_name_or_path: str, image_size: int = 224, *,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        check_full_float32(self.device, "the CLIP encoder")
        self.image_size = image_size
        path = resolve_checkpoint_dir(model_name_or_path)
        spec, state, self.layout = load_clip_checkpoint(path)
        with torch.device("meta"):
            model = CLIP(spec)
        try:
            missing, unexpected = model.load_state_dict(state, strict=False, assign=True)
        except RuntimeError as e:  # a tensor whose shape the config does not give
            raise ValueError(f"CLIP checkpoint {path} does not fit its config: {e}") from e
        if missing or unexpected:
            raise ValueError(f"CLIP checkpoint {path} does not fit its config: "
                             f"missing={sorted(missing)[:8]} unexpected={sorted(unexpected)[:8]}")
        self.model = model.to(self.device).eval()
        try:
            self.tokenizer = CLIPTokenizer.from_pretrained(path)
            self.processor = CLIPImageProcessor.from_pretrained(path)
        except OSError as e:
            if self.layout != "open_clip":
                raise
            raise ValueError(
                f"open_clip checkpoint {path} converted, but no tokenizer/preprocessor files "
                "found beside it; copy a CLIP tokenizer (vocab.json/merges.txt) and "
                "preprocessor_config.json into the directory") from e
        self.feature_dim = spec.projection_dim

    def encode_images(self, images: Sequence[np.ndarray]) -> np.ndarray:
        pixels = torch.from_numpy(self.processor(images)).to(self.device)
        with torch.inference_mode():
            feats = self.model.get_image_features(pixels)
        return l2_normalize(feats.cpu().numpy().astype(np.float32))

    def encode_texts(self, texts: Sequence[str]) -> np.ndarray:
        tokens = self.tokenizer(list(texts))
        ids = torch.from_numpy(tokens["input_ids"]).to(self.device)
        mask = torch.from_numpy(tokens["attention_mask"]).to(self.device)
        with torch.inference_mode():
            feats = self.model.get_text_features(ids, mask)
        return l2_normalize(feats.cpu().numpy().astype(np.float32))


class PrecomputedFeatures:
    """Feature store backed by the reference's npy artifacts.

    ``open-vocabulary_features.npy`` maps ``"{frame_id}_{mask_id}"`` to a
    feature vector; ``<data_root>/text_features/<dataset>.npy`` maps label
    text to a feature.
    """

    def __init__(self, path: str):
        self._dict = np.load(path, allow_pickle=True).item()
        if not self._dict:
            raise ValueError(f"feature store {path} is empty")
        first = next(iter(self._dict.values()))
        self.feature_dim = int(np.asarray(first).shape[-1])

    def __contains__(self, key: str) -> bool:
        return key in self._dict

    def get(self, key: str) -> Optional[np.ndarray]:
        v = self._dict.get(key)
        return None if v is None else np.asarray(v, dtype=np.float32)

    def keys(self):
        return self._dict.keys()
