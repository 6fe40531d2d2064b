"""CLIP checkpoints on disk, read without ``transformers``, ``safetensors``,
``msgpack`` or ``flax``.

The readers give the state dict of ``semantics/clip.py`` (HF ``CLIPModel``
names) from each layout the JAX package's ``HFCLIPEncoder`` loads
(``encoder.py:326-386``), in its order:

1. the open_clip cache layout (``open_clip_config.json`` +
   ``open_clip_pytorch_model.bin``, the reference checkpoint's own), converted
   by the port's copy of ``convert_open_clip_state_dict``
   (``encoder.py:140-227``);
2. the HF layout (``config.json``) with Flax weights (``flax_model.msgpack``),
   carried across as ``load_flax_weights_in_pytorch_model`` does
   (``params_from_flax``);
3. the HF layout with ``model.safetensors``, else ``pytorch_model.bin``.

A missing or unexpected key raises, as ``load_open_clip_checkpoint`` does.
"""

from __future__ import annotations

import json
import os
import re
import struct
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from maskclustering_tpu_torch.semantics.clip_config import CLIPSpec

StateDict = Dict[str, torch.Tensor]


class SafetensorError(Exception):
    """A malformed ``.safetensors`` file (the ``safetensors`` package's
    exception class and messages)."""


# ---------------------------------------------------------------------------
# safetensors: u64 little-endian header length, a JSON header, raw bytes
# ---------------------------------------------------------------------------

_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
    "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}


def read_safetensors(path: str) -> StateDict:
    """Every tensor of a ``.safetensors`` file, on the CPU, in its stored dtype."""
    with open(path, "rb") as f:
        data = bytearray(f.read())
    if len(data) < 8:
        raise SafetensorError("Error while deserializing header: header too small")
    (n,) = struct.unpack("<Q", bytes(data[:8]))
    if 8 + n > len(data):
        raise SafetensorError("Error while deserializing header: invalid header length")
    try:
        header = json.loads(bytes(data[8:8 + n]).decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise SafetensorError(f"Error while deserializing header: {e}") from e
    body = memoryview(data)[8 + n:]
    out: StateDict = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise SafetensorError(f"unsupported dtype {info['dtype']} for {name}")
        start, end = info["data_offsets"]
        shape = tuple(info["shape"])
        count = int(np.prod(shape, dtype=np.int64))
        if end > len(body) or end - start != count * torch.empty((), dtype=dtype).element_size():
            raise SafetensorError(f"Error while deserializing header: {name} does not fit "
                                  f"its offsets {start}..{end}")
        t = (torch.frombuffer(body[start:end], dtype=dtype) if count
             else torch.empty(0, dtype=dtype))
        out[name] = t.reshape(shape)
    return out


# ---------------------------------------------------------------------------
# flax msgpack: maps, strings, bins, ints, floats and flax's ext types
# ---------------------------------------------------------------------------

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


class _Unpacker:
    """A msgpack decoder over one buffer; bins and arrays are views of it."""

    def __init__(self, buf: memoryview):
        self.buf = buf
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        view = self.buf[self.pos:self.pos + n]
        self.pos += n
        return view

    def _uint(self, n: int) -> int:
        return int.from_bytes(self._take(n), "big")

    def _int(self, n: int) -> int:
        return int.from_bytes(self._take(n), "big", signed=True)

    def unpack(self):
        b = self._uint(1)
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.unpack() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self._take(b & 0x1F), "utf-8")
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):
            return self._take(self._uint(1 << (b - 0xC4)))
        if b in (0xC7, 0xC8, 0xC9):
            n = self._uint(1 << (b - 0xC7))
            return self._ext(self._int(1), self._take(n))
        if b == 0xCA:
            return struct.unpack(">f", self._take(4))[0]
        if b == 0xCB:
            return struct.unpack(">d", self._take(8))[0]
        if 0xCC <= b <= 0xCF:
            return self._uint(1 << (b - 0xCC))
        if 0xD0 <= b <= 0xD3:
            return self._int(1 << (b - 0xD0))
        if 0xD4 <= b <= 0xD8:
            code = self._int(1)
            return self._ext(code, self._take(1 << (b - 0xD4)))
        if 0xD9 <= b <= 0xDB:
            return str(self._take(self._uint(1 << (b - 0xD9))), "utf-8")
        if b in (0xDC, 0xDD):
            return [self.unpack() for _ in range(self._uint(2 if b == 0xDC else 4))]
        if b in (0xDE, 0xDF):
            return self._map(self._uint(2 if b == 0xDE else 4))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not used by flax checkpoints")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.unpack()
            out[k] = self.unpack()
        return out

    def _ext(self, code: int, data: memoryview):
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            shape, dtype, raw = _Unpacker(data).unpack()
            arr = _ndarray(shape, dtype, raw)
            return arr[()] if code == _EXT_NPSCALAR else arr
        if code == _EXT_COMPLEX:
            real, imag = _Unpacker(data).unpack()
            return complex(real, imag)
        raise ValueError(f"msgpack ext type {code} is not one of flax's")


def _ndarray(shape, dtype: str, raw: memoryview):
    """flax's ndarray ext payload: numpy, or a torch tensor for bfloat16
    (which numpy lacks)."""
    if dtype == "bfloat16":
        return torch.frombuffer(bytearray(raw), dtype=torch.bfloat16).reshape(tuple(shape))
    return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(tuple(shape))


def _unchunk(tree):
    """flax's chunked form of a leaf over 1 GiB (``_chunk``): the flattened
    array cut into pieces, with its shape, as dicts keyed "0", "1", ..."""
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data) -> dict:
    """The tree ``flax.serialization.msgpack_restore`` gives for ``data``."""
    unpacker = _Unpacker(memoryview(data))
    tree = unpacker.unpack()
    if unpacker.pos != len(unpacker.buf):
        raise ValueError("trailing bytes after the msgpack tree")
    return _unchunk(tree)


def read_flax_msgpack(path: str) -> dict:
    """The parameter tree of a ``flax_model.msgpack``."""
    with open(path, "rb") as f:
        return msgpack_restore(bytearray(f.read()))


def _to_tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v
    return torch.from_numpy(np.array(v, copy=True))


def params_from_flax(tree: Mapping) -> StateDict:
    """A Flax CLIP parameter tree as the port's state dict, the mapping of
    ``load_flax_weights_in_pytorch_model``: a 4-d ``kernel`` (the patch
    convolution, HWIO) becomes an OIHW ``weight``, a 2-d Dense ``kernel``
    transposes, LayerNorm ``scale`` and an ``embedding`` table become
    ``weight``. A ``params`` root is looked through."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: StateDict = {}

    def walk(node, prefix: Tuple[str, ...]):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, prefix + (str(k),))
            return
        t = _to_tensor(node)
        *path, leaf = prefix
        if leaf == "kernel" and t.ndim == 4:
            leaf, t = "weight", t.permute(3, 2, 0, 1)
        elif leaf == "kernel":
            leaf, t = "weight", t.T
        elif leaf in ("scale", "embedding"):
            leaf = "weight"
        out[".".join(path + [leaf])] = t.contiguous()

    walk(tree, ())
    return out


# ---------------------------------------------------------------------------
# open_clip -> HF names (copy of maskclustering_tpu/semantics/encoder.py:140-227)
# ---------------------------------------------------------------------------

# per-resblock submodule map, shared by the vision and text towers
_OC_BLOCK_MAP = (
    ("ln_1.weight", "layer_norm1.weight"),
    ("ln_1.bias", "layer_norm1.bias"),
    ("attn.out_proj.weight", "self_attn.out_proj.weight"),
    ("attn.out_proj.bias", "self_attn.out_proj.bias"),
    ("ln_2.weight", "layer_norm2.weight"),
    ("ln_2.bias", "layer_norm2.bias"),
    ("mlp.c_fc.weight", "mlp.fc1.weight"),
    ("mlp.c_fc.bias", "mlp.fc1.bias"),
    ("mlp.c_proj.weight", "mlp.fc2.weight"),
    ("mlp.c_proj.bias", "mlp.fc2.bias"),
)


def strip_text_prefix(state_dict: Mapping) -> dict:
    """The CustomTextCLIP layout (text tower under ``text.``) with the
    classic flat names. A shallow copy."""
    return {(k[len("text."):] if k.startswith("text.") else k): v
            for k, v in state_dict.items()}


def _convert_block(out: StateDict, src: dict, oc_prefix: str, hf_prefix: str) -> None:
    """One resblock: the fused ``in_proj`` splits row-wise into q/k/v."""
    for oc_name, hf_name in _OC_BLOCK_MAP:
        out[hf_prefix + hf_name] = _to_tensor(src.pop(oc_prefix + oc_name))
    w = _to_tensor(src.pop(oc_prefix + "attn.in_proj_weight"))
    b = _to_tensor(src.pop(oc_prefix + "attn.in_proj_bias"))
    d = w.shape[0] // 3
    for i, proj in enumerate(("q_proj", "k_proj", "v_proj")):
        out[f"{hf_prefix}self_attn.{proj}.weight"] = w[i * d:(i + 1) * d]
        out[f"{hf_prefix}self_attn.{proj}.bias"] = b[i * d:(i + 1) * d]


def convert_open_clip_state_dict(state_dict: Mapping) -> StateDict:
    """open_clip CLIP-ViT weights (torch or numpy) under HF CLIPModel names,
    as torch tensors: the fused attention ``in_proj`` splits into q/k/v
    rows, ``visual.proj`` / ``text_projection`` transpose into ``Linear``
    weights, the embeddings map one to one. An unknown key raises: a weight
    dropped in silence would load a subtly wrong encoder."""
    src = strip_text_prefix(state_dict)
    out: StateDict = {}

    out["vision_model.embeddings.class_embedding"] = \
        _to_tensor(src.pop("visual.class_embedding")).reshape(-1)
    out["vision_model.embeddings.position_embedding.weight"] = \
        _to_tensor(src.pop("visual.positional_embedding"))
    out["vision_model.embeddings.patch_embedding.weight"] = \
        _to_tensor(src.pop("visual.conv1.weight"))
    out["vision_model.pre_layrnorm.weight"] = _to_tensor(src.pop("visual.ln_pre.weight"))
    out["vision_model.pre_layrnorm.bias"] = _to_tensor(src.pop("visual.ln_pre.bias"))
    out["vision_model.post_layernorm.weight"] = _to_tensor(src.pop("visual.ln_post.weight"))
    out["vision_model.post_layernorm.bias"] = _to_tensor(src.pop("visual.ln_post.bias"))
    out["visual_projection.weight"] = _to_tensor(src.pop("visual.proj")).T

    out["text_model.embeddings.token_embedding.weight"] = \
        _to_tensor(src.pop("token_embedding.weight"))
    out["text_model.embeddings.position_embedding.weight"] = \
        _to_tensor(src.pop("positional_embedding"))
    out["text_model.final_layer_norm.weight"] = _to_tensor(src.pop("ln_final.weight"))
    out["text_model.final_layer_norm.bias"] = _to_tensor(src.pop("ln_final.bias"))
    out["text_projection.weight"] = _to_tensor(src.pop("text_projection")).T
    out["logit_scale"] = _to_tensor(src.pop("logit_scale")).reshape(())

    blocks = set()
    for key in src:
        for oc_root, hf_root in (("visual.transformer.resblocks.",
                                  "vision_model.encoder.layers."),
                                 ("transformer.resblocks.", "text_model.encoder.layers.")):
            if key.startswith(oc_root):
                blocks.add((oc_root, hf_root, int(key[len(oc_root):].split(".", 1)[0])))
    for oc_root, hf_root, idx in sorted(blocks):
        _convert_block(out, src, f"{oc_root}{idx}.", f"{hf_root}{idx}.")

    # attn_mask buffers are derived, not weights; anything else is a layout
    # this converter does not understand
    leftovers = [k for k in src if not k.endswith("attn_mask")]
    if leftovers:
        raise ValueError(f"unrecognized open_clip keys (not a classic CLIP-ViT layout?): "
                         f"{sorted(leftovers)[:8]}")
    return out


def is_open_clip_layout(path: str) -> bool:
    """Does ``path`` hold an open_clip cache checkpoint (and not the HF layout)?"""
    return (os.path.isfile(os.path.join(path, "open_clip_config.json"))
            and os.path.isfile(os.path.join(path, "open_clip_pytorch_model.bin"))
            and not os.path.isfile(os.path.join(path, "config.json")))


# ---------------------------------------------------------------------------
# the load order of HFCLIPEncoder
# ---------------------------------------------------------------------------

# a name HF would take for a hub repo id (one optional namespace)
_REPO_ID = re.compile(r"^[\w.\-]+(/[\w.\-]+)?$")


def resolve_checkpoint_dir(name: str) -> str:
    """``name`` when it is a directory, else the local hub-cache snapshot of
    the repo id ``name`` (``HF_HUB_CACHE``; nothing is downloaded).

    What cannot be found raises the class ``transformers`` raises for it
    with downloads off: ``OSError`` for a well-formed repo id with no local
    snapshot, ``ValueError`` for a name that is neither a directory nor a
    repo id (such as a missing absolute path).
    """
    if os.path.isdir(name):
        return name
    if not _REPO_ID.match(name) or "--" in name or ".." in name:
        raise ValueError(f"{name!r} is not a directory, nor a repo id in the form "
                         f"'repo_name' or 'namespace/repo_name'")
    hub = os.environ.get(
        "HF_HUB_CACHE", os.path.join(os.path.expanduser("~"), ".cache", "huggingface", "hub"))
    repo = os.path.join(hub, "models--" + name.replace("/", "--"))
    ref = os.path.join(repo, "refs", "main")
    if os.path.isfile(ref):
        with open(ref) as f:
            snap = os.path.join(repo, "snapshots", f.read().strip())
        if os.path.isdir(snap):
            return snap
    raise OSError(f"no local checkpoint for {name!r}: not a directory and not in the hub "
                  f"cache {hub} (downloads are off)")


def _float32(sd: Mapping) -> StateDict:
    return {k: _to_tensor(v).to(torch.float32).contiguous() for k, v in sd.items()}


def load_clip_checkpoint(path: str) -> Tuple[CLIPSpec, StateDict, str]:
    """(spec, float32 state dict, layout) of a checkpoint directory, in the
    JAX encoder's order; layout is ``open_clip``, ``flax``, ``safetensors``
    or ``torch``. Keys the towers do not derive are all there."""
    if is_open_clip_layout(path):
        with open(os.path.join(path, "open_clip_config.json")) as f:
            oc_config = json.load(f)
        sd = strip_text_prefix(torch.load(os.path.join(path, "open_clip_pytorch_model.bin"),
                                          map_location="cpu", weights_only=True))
        return (CLIPSpec.from_open_clip(oc_config, sd),
                _float32(convert_open_clip_state_dict(sd)), "open_clip")
    config = os.path.join(path, "config.json")
    if not os.path.isfile(config):
        raise OSError(f"{path} holds no config.json (HF layout) and no open_clip_config.json "
                      f"+ open_clip_pytorch_model.bin (open_clip layout)")
    spec = CLIPSpec.from_hf_config(config)
    for name, layout, read in (
            ("flax_model.msgpack", "flax", lambda p: params_from_flax(read_flax_msgpack(p))),
            ("model.safetensors", "safetensors", read_safetensors),
            ("pytorch_model.bin", "torch",
             lambda p: torch.load(p, map_location="cpu", weights_only=True))):
        p = os.path.join(path, name)
        if os.path.isfile(p):
            # position_ids are derived buffers some older checkpoints carry
            sd = {k: v for k, v in read(p).items() if not k.endswith("position_ids")}
            return spec, _float32(sd), layout
    raise OSError(f"{path} has a config.json but no flax_model.msgpack, model.safetensors or "
                  f"pytorch_model.bin")
