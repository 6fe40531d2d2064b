"""CLIP's image and text towers in plain PyTorch, float32.

The port of what the JAX package runs through ``transformers``
(``FlaxCLIPModel`` / ``CLIPModel``: ``get_image_features``,
``get_text_features``). The modules carry HF's state-dict names, so a
converted checkpoint loads with ``load_state_dict(strict=True)`` as is.

No hand-written kernel: the JAX side runs these towers as XLA programs, with
no Pallas. Attention is a product, an additive mask and a softmax, as HF's
eager and Flax paths compute it. The patch embedding (a convolution whose
stride is its kernel) is the same product over unfolded patches, so every
product of both towers is a float32 ``matmul``, which the encoder refuses to
run where this process lets those round to TF32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from maskclustering_tpu_torch.semantics.clip_config import CLIPSpec


def _act(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    return F.gelu  # exact (erf) GeLU, HF's "gelu"


class CLIPAttention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.head_dim = width // heads
        self.scale = self.head_dim ** -0.5
        self.q_proj = nn.Linear(width, width)
        self.k_proj = nn.Linear(width, width)
        self.v_proj = nn.Linear(width, width)
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, mask) -> torch.Tensor:
        b, t, d = x.shape

        def split(y):
            return y.reshape(b, t, self.heads, self.head_dim).transpose(1, 2)

        q, k, v = split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x))
        weights = torch.matmul(q, k.transpose(-1, -2)) * self.scale
        if mask is not None:
            weights = weights + mask
        weights = torch.softmax(weights, dim=-1)
        out = torch.matmul(weights, v).transpose(1, 2).reshape(b, t, d)
        return self.out_proj(out)


class CLIPMLP(nn.Module):
    def __init__(self, width: int, hidden: int, act: str):
        super().__init__()
        self.fc1 = nn.Linear(width, hidden)
        self.fc2 = nn.Linear(hidden, width)
        self.act = _act(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    """Pre-LN residual block: attention, then the MLP."""

    def __init__(self, width: int, heads: int, hidden: int, act: str, eps: float):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(width, eps=eps)
        self.self_attn = CLIPAttention(width, heads)
        self.layer_norm2 = nn.LayerNorm(width, eps=eps)
        self.mlp = CLIPMLP(width, hidden, act)

    def forward(self, x: torch.Tensor, mask) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEncoder(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, hidden: int, act: str, eps: float):
        super().__init__()
        self.layers = nn.ModuleList(
            CLIPEncoderLayer(width, heads, hidden, act, eps) for _ in range(layers))

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, mask)
        return x


class _PatchEmbedding(nn.Module):
    """The bias-free patch convolution, as one product over unfolded patches.

    The weight keeps the convolution's (width, channels, p, p) shape and name.
    """

    def __init__(self, width: int, channels: int, patch: int):
        super().__init__()
        self.patch = patch
        self.weight = nn.Parameter(torch.zeros(width, channels, patch, patch))

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        b, c, h, w = pixels.shape
        p = self.patch
        patches = (pixels.reshape(b, c, h // p, p, w // p, p)
                   .permute(0, 2, 4, 1, 3, 5).reshape(b, (h // p) * (w // p), c * p * p))
        return torch.matmul(patches, self.weight.reshape(self.weight.shape[0], -1).T)


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, spec: CLIPSpec):
        super().__init__()
        self.class_embedding = nn.Parameter(torch.zeros(spec.vision_width))
        self.patch_embedding = _PatchEmbedding(spec.vision_width, spec.num_channels,
                                               spec.patch_size)
        self.position_embedding = nn.Embedding(spec.num_patches + 1, spec.vision_width)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        patches = self.patch_embedding(pixels)
        cls = self.class_embedding.expand(pixels.shape[0], 1, -1)
        return torch.cat([cls, patches], dim=1) + self.position_embedding.weight


class CLIPVisionTower(nn.Module):
    """Patch embedding, class token, pre-LN, encoder, post-LN on token 0."""

    def __init__(self, spec: CLIPSpec):
        super().__init__()
        self.spec = spec
        self.embeddings = CLIPVisionEmbeddings(spec)
        # HF's spelling
        self.pre_layrnorm = nn.LayerNorm(spec.vision_width, eps=spec.vision_layer_norm_eps)
        self.encoder = CLIPEncoder(spec.vision_width, spec.vision_layers, spec.vision_heads,
                                   spec.vision_mlp, spec.vision_act, spec.vision_layer_norm_eps)
        self.post_layernorm = nn.LayerNorm(spec.vision_width, eps=spec.vision_layer_norm_eps)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        size = self.spec.image_size
        if pixels.ndim != 4 or tuple(pixels.shape[1:]) != (self.spec.num_channels, size, size):
            raise ValueError(f"pixel_values {tuple(pixels.shape)}, expected "
                             f"(B, {self.spec.num_channels}, {size}, {size})")
        x = self.encoder(self.pre_layrnorm(self.embeddings(pixels)))
        return self.post_layernorm(x[:, 0, :])


class CLIPTextEmbeddings(nn.Module):
    def __init__(self, spec: CLIPSpec):
        super().__init__()
        self.token_embedding = nn.Embedding(spec.vocab_size, spec.text_width)
        self.position_embedding = nn.Embedding(spec.context_length, spec.text_width)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.token_embedding(ids) + self.position_embedding.weight[:ids.shape[1]]


class CLIPTextTower(nn.Module):
    """Token and position embeddings, causal and padding masks, final LN,
    then the pooled position: HF's rule, see ``pool_positions``."""

    def __init__(self, spec: CLIPSpec):
        super().__init__()
        self.spec = spec
        self.embeddings = CLIPTextEmbeddings(spec)
        self.encoder = CLIPEncoder(spec.text_width, spec.text_layers, spec.text_heads,
                                   spec.text_mlp, spec.text_act, spec.text_layer_norm_eps)
        self.final_layer_norm = nn.LayerNorm(spec.text_width, eps=spec.text_layer_norm_eps)

    def pool_positions(self, ids: torch.Tensor) -> torch.Tensor:
        """(B,) positions pooled: with ``eos_token_id == 2`` (configs from
        before the rule changed) the position of the largest id, else the
        first position holding ``eos_token_id``, and position 0 when no
        position does (argmax of an all-zero row)."""
        if self.spec.eos_token_id == 2:
            return ids.argmax(dim=-1)
        return (ids == self.spec.eos_token_id).int().argmax(dim=-1)

    def forward(self, ids: torch.Tensor, attention_mask=None) -> torch.Tensor:
        b, t = ids.shape
        if t > self.spec.context_length:
            raise ValueError(f"{t} tokens exceed the context length {self.spec.context_length}")
        x = self.embeddings(ids)
        neg = torch.finfo(x.dtype).min
        # HF adds the causal mask and the padding mask, each 0 or the dtype's min
        mask = torch.full((t, t), neg, dtype=x.dtype, device=x.device).triu(1)[None, None]
        if attention_mask is not None:
            pad = (1.0 - attention_mask.to(x.dtype))[:, None, None, :] * neg
            mask = mask + pad
        x = self.final_layer_norm(self.encoder(x, mask))
        return x[torch.arange(b, device=x.device), self.pool_positions(ids)]


class CLIP(nn.Module):
    """Both towers and their bias-free projections (HF ``CLIPModel``)."""

    def __init__(self, spec: CLIPSpec):
        super().__init__()
        self.spec = spec
        self.vision_model = CLIPVisionTower(spec)
        self.text_model = CLIPTextTower(spec)
        self.visual_projection = nn.Linear(spec.vision_width, spec.projection_dim, bias=False)
        self.text_projection = nn.Linear(spec.text_width, spec.projection_dim, bias=False)
        # carried so a checkpoint loads strictly; the features do not use it
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))

    def get_image_features(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """(B, projection_dim) unnormalised image features."""
        return self.visual_projection(self.vision_model(pixel_values))

    def get_text_features(self, input_ids: torch.Tensor,
                          attention_mask=None) -> torch.Tensor:
        """(B, projection_dim) unnormalised text features."""
        return self.text_projection(self.text_model(input_ids, attention_mask))
