"""Shape and behaviour of a CLIP model: the two towers and the projection.

The port's counterpart of what the JAX package takes from ``transformers``'
``CLIPConfig`` / ``CLIPTextConfig`` / ``CLIPVisionConfig``: read from an HF
``config.json`` (absent fields take HF's defaults) or derived from an
open_clip checkpoint (``encoder.py:230-282``, ``hf_clip_config_from_open_clip``).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Mapping

import numpy as np

# transformers' CLIPTextConfig / CLIPVisionConfig defaults (the fields a
# config.json written with use_diff may leave out); both acts default to
# OpenAI's quick_gelu
_TEXT_DEFAULTS = dict(vocab_size=49408, hidden_size=512, intermediate_size=2048,
                      num_hidden_layers=12, num_attention_heads=8,
                      max_position_embeddings=77, hidden_act="quick_gelu",
                      layer_norm_eps=1e-5, eos_token_id=49407)
_VISION_DEFAULTS = dict(hidden_size=768, intermediate_size=3072, num_hidden_layers=12,
                        num_attention_heads=12, num_channels=3, image_size=224, patch_size=32,
                        hidden_act="quick_gelu", layer_norm_eps=1e-5)
_PROJECTION_DEFAULT = 512

ACTS = ("gelu", "quick_gelu")


@dataclasses.dataclass(frozen=True)
class CLIPSpec:
    """Everything the towers' shapes and arithmetic depend on."""

    # text tower
    vocab_size: int = _TEXT_DEFAULTS["vocab_size"]
    text_width: int = _TEXT_DEFAULTS["hidden_size"]
    text_layers: int = _TEXT_DEFAULTS["num_hidden_layers"]
    text_heads: int = _TEXT_DEFAULTS["num_attention_heads"]
    text_mlp: int = _TEXT_DEFAULTS["intermediate_size"]
    context_length: int = _TEXT_DEFAULTS["max_position_embeddings"]
    text_act: str = _TEXT_DEFAULTS["hidden_act"]
    text_layer_norm_eps: float = _TEXT_DEFAULTS["layer_norm_eps"]
    # the text tower pools at the first position holding this id; 2 selects
    # the pre-2023 rule (the position of the largest id), as HF keeps it
    eos_token_id: int = _TEXT_DEFAULTS["eos_token_id"]
    # image tower
    vision_width: int = _VISION_DEFAULTS["hidden_size"]
    vision_layers: int = _VISION_DEFAULTS["num_hidden_layers"]
    vision_heads: int = _VISION_DEFAULTS["num_attention_heads"]
    vision_mlp: int = _VISION_DEFAULTS["intermediate_size"]
    num_channels: int = _VISION_DEFAULTS["num_channels"]
    image_size: int = _VISION_DEFAULTS["image_size"]
    patch_size: int = _VISION_DEFAULTS["patch_size"]
    vision_act: str = _VISION_DEFAULTS["hidden_act"]
    vision_layer_norm_eps: float = _VISION_DEFAULTS["layer_norm_eps"]
    # both towers project to this width (the features' dimension)
    projection_dim: int = _PROJECTION_DEFAULT

    def __post_init__(self):
        for act in (self.text_act, self.vision_act):
            if act not in ACTS:
                raise ValueError(f"unsupported CLIP activation {act!r} (supported: {ACTS})")
        for width, heads in ((self.text_width, self.text_heads),
                             (self.vision_width, self.vision_heads)):
            if heads <= 0 or width % heads:
                raise ValueError(f"width {width} does not split into {heads} heads")
        if self.image_size % self.patch_size:
            raise ValueError(f"image size {self.image_size} is not a multiple of the patch "
                             f"{self.patch_size}")

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @classmethod
    def from_hf_dict(cls, config: Mapping) -> "CLIPSpec":
        """From the dict of an HF CLIPModel ``config.json``. The legacy
        ``*_config_dict`` entries take precedence, as in ``CLIPConfig``."""
        text = {**_TEXT_DEFAULTS, **(config.get("text_config") or {}),
                **(config.get("text_config_dict") or {})}
        vision = {**_VISION_DEFAULTS, **(config.get("vision_config") or {}),
                  **(config.get("vision_config_dict") or {})}
        return cls(
            vocab_size=int(text["vocab_size"]), text_width=int(text["hidden_size"]),
            text_layers=int(text["num_hidden_layers"]),
            text_heads=int(text["num_attention_heads"]),
            text_mlp=int(text["intermediate_size"]),
            context_length=int(text["max_position_embeddings"]),
            text_act=str(text["hidden_act"]), text_layer_norm_eps=float(text["layer_norm_eps"]),
            eos_token_id=int(text["eos_token_id"]),
            vision_width=int(vision["hidden_size"]),
            vision_layers=int(vision["num_hidden_layers"]),
            vision_heads=int(vision["num_attention_heads"]),
            vision_mlp=int(vision["intermediate_size"]),
            num_channels=int(vision["num_channels"]), image_size=int(vision["image_size"]),
            patch_size=int(vision["patch_size"]), vision_act=str(vision["hidden_act"]),
            vision_layer_norm_eps=float(vision["layer_norm_eps"]),
            projection_dim=int(config.get("projection_dim", _PROJECTION_DEFAULT)))

    @classmethod
    def from_hf_config(cls, path: str) -> "CLIPSpec":
        """From an HF ``config.json`` file."""
        with open(path) as f:
            return cls.from_hf_dict(json.load(f))

    @classmethod
    def from_open_clip(cls, oc_config: Mapping, state_dict: Mapping) -> "CLIPSpec":
        """From an ``open_clip_config.json`` and its (flat-named) weights.

        Widths, depths, vocabulary and MLP widths come from the weights; the
        config gives the heads (``heads``, ``width // head_width``, default
        head width 64), the context length and the act: open_clip models use
        exact GeLU unless the config sets ``quick_gelu``. The rest keeps
        ``CLIPTextConfig`` / ``CLIPVisionConfig``'s defaults, as
        ``hf_clip_config_from_open_clip`` leaves them.
        """
        model_cfg = oc_config.get("model_cfg", oc_config)
        vis, txt = model_cfg.get("vision_cfg", {}), model_cfg.get("text_cfg", {})
        v_width, _, patch, _ = (int(x) for x in _shape(state_dict["visual.conv1.weight"]))
        vocab, t_width = (int(x) for x in _shape(state_dict["token_embedding.weight"]))
        embed_dim = int(model_cfg.get("embed_dim", _shape(state_dict["text_projection"])[1]))
        v_layers = len({k.split(".")[3] for k in state_dict
                        if k.startswith("visual.transformer.resblocks.")})
        t_layers = len({k.split(".")[2] for k in state_dict
                        if k.startswith("transformer.resblocks.")})

        def mlp(prefix: str, width: int) -> int:
            key = f"{prefix}.resblocks.0.mlp.c_fc.weight"
            return int(_shape(state_dict[key])[0]) if key in state_dict else 4 * width

        act = "quick_gelu" if model_cfg.get("quick_gelu") else "gelu"
        return cls(
            vocab_size=vocab, text_width=t_width, text_layers=t_layers,
            text_heads=int(txt.get("heads", t_width // 64)),
            text_mlp=mlp("transformer", t_width),
            context_length=int(txt.get("context_length", 77)), text_act=act,
            vision_width=v_width, vision_layers=v_layers,
            vision_heads=v_width // int(vis.get("head_width", 64)),
            vision_mlp=mlp("visual.transformer", v_width),
            image_size=int(vis.get("image_size", 224)), patch_size=patch, vision_act=act,
            projection_dim=embed_dim)

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


def _shape(v) -> tuple:
    return tuple(v.shape) if hasattr(v, "shape") else np.shape(v)
