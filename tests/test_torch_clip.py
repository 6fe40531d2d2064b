"""The port's CLIP encoder against the JAX package's and ``transformers``.

Tiny random checkpoints are built at test time, with no downloads: the HF
layout (``config.json`` with Flax, safetensors and torch weights, as
``tests/test_semantics_hfclip.py`` builds it) and the open_clip layout (as
``tests/test_openclip_convert.py``). Against them:

- the tokenizer's ids and masks equal ``CLIPTokenizerFast``'s, on a tiny
  vocabulary and on a byte-level one built here, over every label of the
  three vocabularies and edge strings, and over every code point;
- ``pixel_values`` bit-equal to the slow ``CLIPImageProcessor``'s;
- the state dicts of the three weight files bit-equal; the msgpack reader
  equal to ``flax.serialization.msgpack_restore``, a chunked leaf included;
- the open_clip conversion and spec equal to the JAX package's;
- ``encode_images`` / ``encode_texts`` within 1e-6 of the JAX
  ``HFCLIPEncoder`` on its Flax path, its torch fallback, a safetensors-only
  checkpoint and the open_clip layout, with both text pooling rules;
- the batch driver's seven default steps with ``--encoder hf:<dir>`` equal
  to the JAX driver's: features within 1e-6, class-aware npz and AP equal.

Everything runs with ``device="cpu"``.
"""

import collections
import dataclasses
import json
import math
import os
import shutil

import numpy as np
import pytest
import torch

from maskclustering_tpu.semantics import HFCLIPEncoder as JaxHFCLIPEncoder
from maskclustering_tpu.semantics.encoder import (
    convert_open_clip_state_dict as jax_convert_open_clip_state_dict,
)
from maskclustering_tpu.semantics.encoder import hf_clip_config_from_open_clip
from maskclustering_tpu_torch.semantics import HFCLIPEncoder, get_vocab
from maskclustering_tpu_torch.semantics import checkpoint as ckpt
from maskclustering_tpu_torch.semantics.clip import CLIP
from maskclustering_tpu_torch.semantics.clip_config import CLIPSpec
from maskclustering_tpu_torch.semantics.image_processor import CLIPImageProcessor
from maskclustering_tpu_torch.semantics.tokenizer import CLIPTokenizer, bytes_to_unicode

transformers = pytest.importorskip("transformers")

# one intra-op thread: the suite runs in parallel worker processes
torch.set_num_threads(1)

# the JAX fixtures' tiny vocabulary (tests/test_semantics_hfclip.py)
VOCAB = ["l", "o", "w", "e", "r", "s", "t", "i", "d", "n",
         "lo", "l</w>", "w</w>", "r</w>", "t</w>",
         "low</w>", "er</w>", "lowest</w>", "newer</w>", "wider",
         "<unk>", "<|startoftext|>", "<|endoftext|>"]
MERGES = ["#version: 0.2", "l o", "lo w</w>", "e r</w>"]
VOCAB_DATASETS = ("scannet", "scannetpp", "matterport3d")
EDGE_TEXTS = [
    "", "Café crème brûlée", "naïve Ελληνικά ΣΟΦΟΣ", "日本語のテキスト 中文", "3d printer 2x4 ½ ٣",
    "it's they'll we'd I'M YOU'RE rock'n'roll ''s", "tab\tnew\nline   spaces  \r\n",
    "UPPER case", "emoji 😀👍🏽 ok", "a <|endoftext|> b<|startoftext|>c",
    "x y　w​q᠎r﻿s\x1ct\x85u\xa0v", "é combining", "İstanbul ǅ ß ﬁ",
    "!!!'s ?'t ...", "tv-stand 10,000 $5.99", "'", "’s curly", "lower newer wider lowest",
]
FEATURE_ATOL = 1e-6


def _labels():
    return [lab for ds in VOCAB_DATASETS for lab in get_vocab(ds)[0]]


def _write_tiny_tokenizer(d):
    (d / "vocab.json").write_text(json.dumps({tok: i for i, tok in enumerate(VOCAB)}))
    (d / "merges.txt").write_text("\n".join(MERGES))
    transformers.CLIPTokenizer(str(d / "vocab.json"), str(d / "merges.txt")).save_pretrained(
        str(d))


def _write_byte_level_tokenizer(d, n_merges=300):
    """The 256 byte symbols, their ``</w>`` forms, the ``n_merges`` most
    frequent pairs of the vocabularies' words (learned greedily) and the two
    special tokens."""
    b2u = bytes_to_unicode()
    symbols = list(b2u.values())
    vocab = symbols + [s + "</w>" for s in symbols]
    words = collections.Counter()
    for label in _labels():
        for w in label.lower().split():
            chars = [b2u[b] for b in w.encode()]
            chars[-1] += "</w>"
            words[tuple(chars)] += 1
    merges = []
    for _ in range(n_merges):
        pairs = collections.Counter()
        for w, c in words.items():
            for pair in zip(w, w[1:]):
                pairs[pair] += c
        if not pairs:
            break
        (a, b), _ = pairs.most_common(1)[0]
        merges.append((a, b))
        vocab.append(a + b)
        merged = collections.Counter()
        for w, c in words.items():
            out, i = [], 0
            while i < len(w):
                if i + 1 < len(w) and (w[i], w[i + 1]) == (a, b):
                    out.append(a + b)
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            merged[tuple(out)] += c
        words = merged
    vocab += ["<|startoftext|>", "<|endoftext|>"]
    (d / "vocab.json").write_text(json.dumps({t: i for i, t in enumerate(vocab)}))
    (d / "merges.txt").write_text("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges))
    transformers.CLIPTokenizer(str(d / "vocab.json"), str(d / "merges.txt")).save_pretrained(
        str(d))


@pytest.fixture(scope="module")
def tokenizer_dirs(tmp_path_factory):
    tiny = tmp_path_factory.mktemp("tok_tiny")
    _write_tiny_tokenizer(tiny)
    byte_level = tmp_path_factory.mktemp("tok_bytes")
    _write_byte_level_tokenizer(byte_level)
    return {"tiny": str(tiny), "byte_level": str(byte_level)}


# ---------------------------------------------------------------------------
# 1. tokenizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["tiny", "byte_level"])
@pytest.mark.parametrize("texts", ["labels", "edges"])
def test_tokenizer_equals_clip_tokenizer_fast(tokenizer_dirs, which, texts):
    d = tokenizer_dirs[which]
    fast = transformers.CLIPTokenizerFast.from_pretrained(d)
    mine = CLIPTokenizer.from_pretrained(d)
    batch = _labels() if texts == "labels" else EDGE_TEXTS
    want = fast(batch, padding=True, return_tensors="np")
    got = mine(batch)
    for text, ids in zip(batch, fast(batch)["input_ids"]):
        assert mine.encode(text) == list(ids), text
    np.testing.assert_array_equal(got["input_ids"], want["input_ids"])
    np.testing.assert_array_equal(got["attention_mask"], want["attention_mask"])
    assert got["input_ids"].dtype == np.int64 and got["attention_mask"].dtype == np.int64


def _differing_code_points(d, points):
    """The code points whose three contexts tokenise differently in the
    port and in CLIPTokenizerFast."""
    fast = transformers.CLIPTokenizerFast.from_pretrained(d)
    mine = CLIPTokenizer.from_pretrained(d)
    texts = [f"a{chr(c)}b {chr(c)}{chr(c)}X 1{chr(c)}" for c in points]
    differ = []
    for start in range(0, len(texts), 4096):
        chunk = texts[start:start + 4096]
        for c, text, ids in zip(points[start:], chunk, fast(chunk)["input_ids"]):
            if mine.encode(text) != list(ids):
                differ.append(c)
    return differ


def _newer_table_code_points():
    from maskclustering_tpu_torch.semantics import tokenizer as tok

    ranges = ([r[:2] for r in tok._NEWER_LOWERCASE] + list(tok._NEWER_LETTERS)
              + list(tok._NEWER_NUMBERS))
    return sorted({c for first, last in ranges for c in range(first, last + 1)})


def test_tokenizer_every_code_point(tokenizer_dirs):
    """Each code point in three contexts, over the BMP, two supplementary
    blocks and every code point of the tokenizer's newer-Unicode tables:
    no difference (ROADMAP.md §C, C2)."""
    table = _newer_table_code_points()
    points = sorted({*range(0xD800), *range(0xE000, 0x11000), *range(0x1F000, 0x1FB00),
                     *table})
    assert len(table) > 4900
    assert _differing_code_points(tokenizer_dirs["byte_level"], points) == []


@pytest.mark.slow
def test_tokenizer_every_code_point_full_plane(tokenizer_dirs):
    """The same over all 1,112,064 code points but the surrogates."""
    points = [*range(0xD800), *range(0xE000, 0x110000)]
    assert _differing_code_points(tokenizer_dirs["byte_level"], points) == []


def test_tokenizer_refusals(tokenizer_dirs, tmp_path):
    vocab = {"a</w>": 0, "<|startoftext|>": 1, "<|endoftext|>": 2}
    with pytest.raises(ValueError, match="missing from the vocabulary"):
        CLIPTokenizer(vocab, [("a", "b")])
    with pytest.raises(ValueError, match="not in the vocabulary"):
        CLIPTokenizer({"a</w>": 0}, [])
    mine = CLIPTokenizer.from_pretrained(tokenizer_dirs["tiny"])
    # a symbol outside the vocabulary is the unknown token, never dropped
    assert mine.encode("z") == [21, 22, 22]
    assert mine(["", "low"])["attention_mask"].tolist() == [[1, 1, 0], [1, 1, 1]]


# ---------------------------------------------------------------------------
# 2. image processor
# ---------------------------------------------------------------------------

# (7, 1, 3) is a 7x1 strip; (1, 7, 3), (1, 1, 3) and (3, 3, 3) are what HF
# reads as channels first, so HF is told the layout there
UNAMBIGUOUS = [(7, 1, 3), (2, 2, 3), (5, 9, 3), (31, 17, 3), (32, 32, 3), (33, 33, 3),
               (100, 37, 3), (224, 224, 3), (225, 223, 3), (223, 224, 3), (480, 640, 3),
               (57, 1000, 3), (400, 1, 3), (968, 968, 3)]
AMBIGUOUS = [(1, 7, 3), (1, 1, 3), (3, 3, 3), (1, 400, 3), (3, 50, 3)]


@pytest.mark.parametrize("edge", [32, 224])
@pytest.mark.parametrize("shapes,layout", [(UNAMBIGUOUS, None), (AMBIGUOUS, "channels_last")])
def test_pixel_values_bit_equal(tmp_path, edge, shapes, layout):
    hf = transformers.CLIPImageProcessor(size={"shortest_edge": edge},
                                         crop_size={"height": edge, "width": edge})
    hf.save_pretrained(str(tmp_path))
    mine = CLIPImageProcessor.from_pretrained(str(tmp_path))
    rng = np.random.default_rng(edge)
    for shape in shapes:
        image = rng.integers(0, 256, shape, dtype=np.uint8)
        want = hf(images=[image], return_tensors="np", input_data_format=layout)["pixel_values"]
        got = mine([image])
        assert got.shape == want.shape == (1, 3, edge, edge) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=str(shape))
    # a batch, as the encoder passes it
    images = [rng.integers(0, 256, s, dtype=np.uint8) for s in shapes if s[0] > 3]
    if images:
        np.testing.assert_array_equal(
            mine(images), hf(images=images, return_tensors="np")["pixel_values"])


def test_hf_reads_a_three_row_image_as_channels_first(tmp_path):
    """The reference difference the port does not copy (ROADMAP.md §C): HF
    takes a 3x3x3 crop as channels first; the port reads channels last, as
    HF does when told."""
    hf = transformers.CLIPImageProcessor(size={"shortest_edge": 32},
                                         crop_size={"height": 32, "width": 32})
    image = np.random.default_rng(1).integers(0, 256, (3, 3, 3), dtype=np.uint8)
    inferred = hf(images=[image], return_tensors="np")["pixel_values"]
    told = hf(images=[image], return_tensors="np",
              input_data_format="channels_last")["pixel_values"]
    hf.save_pretrained(str(tmp_path))
    got = CLIPImageProcessor.from_pretrained(str(tmp_path))([image])
    np.testing.assert_array_equal(got, told)
    assert not np.array_equal(got, inferred)
    with pytest.raises(ValueError, match="HxWx3 uint8"):
        CLIPImageProcessor()([image.astype(np.float32)])
    with pytest.raises(ValueError, match="resample"):
        CLIPImageProcessor(resample=2)


# ---------------------------------------------------------------------------
# HF-layout checkpoints: Flax, safetensors and torch weights of one model
# ---------------------------------------------------------------------------


def _hf_config(eos_token_id=None):
    text = dict(vocab_size=len(VOCAB), hidden_size=32, intermediate_size=64,
                num_hidden_layers=2, num_attention_heads=4, max_position_embeddings=77,
                projection_dim=16)
    if eos_token_id is not None:
        text["eos_token_id"] = eos_token_id
    vision = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                  num_attention_heads=4, image_size=32, patch_size=8, projection_dim=16)
    return transformers.CLIPConfig(text_config=text, vision_config=vision, projection_dim=16)


def _write_hf_dir(d, eos_token_id=None, seed=0):
    """config.json, the three weight files of one Flax-initialised model,
    the tiny tokenizer and a 32-pixel preprocessor."""
    from transformers.modeling_flax_pytorch_utils import load_flax_weights_in_pytorch_model

    _write_tiny_tokenizer(d)
    transformers.CLIPImageProcessor(size={"shortest_edge": 32},
                                    crop_size={"height": 32, "width": 32}).save_pretrained(str(d))
    cfg = _hf_config(eos_token_id)
    flax_model = transformers.FlaxCLIPModel(cfg, seed=seed)
    flax_model.save_pretrained(str(d))
    pt_model = transformers.CLIPModel(cfg)
    load_flax_weights_in_pytorch_model(pt_model, flax_model.params)
    pt_model.save_pretrained(str(d), safe_serialization=False)
    pt_model.save_pretrained(str(d), safe_serialization=True)
    return flax_model


def _only(src, dst, weights):
    """A copy of checkpoint dir ``src`` holding one of its weight files."""
    shutil.copytree(src, dst)
    for name in ("flax_model.msgpack", "model.safetensors", "pytorch_model.bin"):
        if name != weights:
            os.remove(os.path.join(dst, name))
    return str(dst)


@pytest.fixture(scope="module", params=[None, 2], ids=["eos_default", "eos_2"])
def hf_dirs(request, tmp_path_factory):
    root = tmp_path_factory.mktemp(f"hf_clip_{request.param}")
    full = root / "all"
    full.mkdir()
    flax_model = _write_hf_dir(full, request.param)
    return {"all": str(full), "params": flax_model.params, "eos": request.param,
            "torch": _only(full, root / "torch", "pytorch_model.bin"),
            "safetensors": _only(full, root / "safetensors", "model.safetensors")}


# ---------------------------------------------------------------------------
# 3. readers
# ---------------------------------------------------------------------------


def test_weight_files_read_bit_equal(hf_dirs):
    d = hf_dirs["all"]
    from_bin = {k: v for k, v in torch.load(os.path.join(d, "pytorch_model.bin"),
                                            weights_only=True).items()}
    from_st = ckpt.read_safetensors(os.path.join(d, "model.safetensors"))
    from_flax = ckpt.params_from_flax(ckpt.read_flax_msgpack(os.path.join(d,
                                                                          "flax_model.msgpack")))
    want = {k for k in transformers.CLIPModel(_hf_config()).state_dict()
            if not k.endswith("position_ids")}
    from safetensors.torch import load_file

    library = load_file(os.path.join(d, "model.safetensors"))
    for sd in (from_bin, from_st, from_flax):
        assert set(sd) - {"text_model.embeddings.position_ids",
                          "vision_model.embeddings.position_ids"} == want
    for k in want:
        for sd in (from_st, from_flax):
            assert sd[k].dtype == from_bin[k].dtype and sd[k].shape == from_bin[k].shape, k
            assert torch.equal(sd[k], from_bin[k]), k
        assert torch.equal(library[k], from_st[k]), k
    # the params carried across from the JAX package's tree equal the file's
    import jax

    carried = ckpt.params_from_flax(
        {"params": jax.tree_util.tree_map(np.asarray, hf_dirs["params"])})
    for k in want:
        assert torch.equal(carried[k], from_flax[k]), k
    # and they load strictly into the port's towers
    spec = CLIPSpec.from_hf_config(os.path.join(d, "config.json"))
    CLIP(spec).load_state_dict(from_flax, strict=True)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def test_msgpack_reader_equals_flax(hf_dirs, monkeypatch):
    import flax.serialization as fser
    import jax

    with open(os.path.join(hf_dirs["all"], "flax_model.msgpack"), "rb") as f:
        data = f.read()
    tree = jax.tree_util.tree_map(np.asarray, fser.msgpack_restore(data))
    # a chunked leaf (flax chunks leaves over MAX_CHUNK_SIZE bytes), and the
    # other leaf kinds flax writes: scalars, bools, strings, numpy scalars,
    # float64, int and complex values
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 1000)
    tree = dict(tree, extra={"big": np.arange(3000, dtype=np.float32).reshape(30, 100),
                             "i": 7, "neg": -40000, "f": 0.25, "b": True, "s": "text",
                             "none": None, "np": np.float32(2.5), "c": 1 + 2j,
                             "f64": np.linspace(0, 1, 5), "i8": np.arange(-3, 3, dtype=np.int8),
                             "list": [1, 2.0, "x"]})
    packed = fser.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in packed
    want, got = fser.msgpack_restore(packed), ckpt.msgpack_restore(packed)
    want_leaves, got_leaves = dict(_leaves(want)), dict(_leaves(got))
    assert list(want_leaves) == list(got_leaves)
    for k, w in want_leaves.items():
        g = got_leaves[k]
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype and g.shape == w.shape, k
            np.testing.assert_array_equal(g, w, err_msg=str(k))
        else:
            assert type(g) is type(w) and g == w, k


def test_safetensors_reader_dtypes_and_errors(tmp_path):
    from safetensors import SafetensorError as LibraryError
    from safetensors.torch import load_file, save_file

    tensors = {"f32": torch.randn(3, 4), "f16": torch.randn(5).half(),
               "bf16": torch.randn(2, 3).bfloat16(), "i64": torch.arange(6).reshape(2, 3),
               "u8": torch.arange(4, dtype=torch.uint8), "empty": torch.zeros(0, 3),
               "scalar": torch.tensor(1.5)}
    path = str(tmp_path / "m.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    got, want = ckpt.read_safetensors(path), load_file(path)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k
    for data in (b"", b"\x01\x02"):
        (tmp_path / "bad.safetensors").write_bytes(data)
        with pytest.raises(LibraryError) as lib:
            load_file(str(tmp_path / "bad.safetensors"))
        with pytest.raises(ckpt.SafetensorError) as port:
            ckpt.read_safetensors(str(tmp_path / "bad.safetensors"))
        assert str(port.value) == str(lib.value)


# ---------------------------------------------------------------------------
# 4. open_clip conversion and spec
# ---------------------------------------------------------------------------

_OC_BLOCK = ("ln_1.weight", "ln_1.bias", "attn.out_proj.weight", "attn.out_proj.bias",
             "ln_2.weight", "ln_2.bias", "mlp.c_fc.weight", "mlp.c_fc.bias",
             "mlp.c_proj.weight", "mlp.c_proj.bias")


def _open_clip_state(seed, *, width=32, t_width=32, layers=2, inter=64, vocab=len(VOCAB),
                     proj=16, patch=8, image=32, context=77, text_prefix=False):
    """A random open_clip CLIP-ViT state dict (torch tensors), scaled so the
    towers stay well conditioned."""
    g = torch.Generator().manual_seed(seed)

    def rand(*shape, scale=0.05):
        return torch.randn(*shape, generator=g) * scale

    def ln(n):
        return 1.0 + rand(n, scale=0.1), rand(n, scale=0.1)

    sd = {"visual.class_embedding": rand(width, scale=0.5),
          "visual.positional_embedding": rand((image // patch) ** 2 + 1, width, scale=0.5),
          "visual.conv1.weight": rand(width, 3, patch, patch, scale=0.1),
          "visual.proj": rand(width, proj, scale=0.2),
          "token_embedding.weight": rand(vocab, t_width, scale=0.5),
          "positional_embedding": rand(context, t_width, scale=0.5),
          "text_projection": rand(t_width, proj, scale=0.2),
          "logit_scale": torch.tensor(math.log(1 / 0.07)),
          "attn_mask": torch.zeros(context, context)}
    for name in ("visual.ln_pre", "visual.ln_post", "ln_final"):
        w = t_width if name == "ln_final" else width
        sd[name + ".weight"], sd[name + ".bias"] = ln(w)
    for root, w in (("visual.transformer", width), ("transformer", t_width)):
        for i in range(layers):
            p = f"{root}.resblocks.{i}."
            sd[p + "attn.in_proj_weight"] = rand(3 * w, w, scale=0.15)
            sd[p + "attn.in_proj_bias"] = rand(3 * w, scale=0.05)
            sd[p + "ln_1.weight"], sd[p + "ln_1.bias"] = ln(w)
            sd[p + "ln_2.weight"], sd[p + "ln_2.bias"] = ln(w)
            sd[p + "attn.out_proj.weight"] = rand(w, w, scale=0.15)
            sd[p + "attn.out_proj.bias"] = rand(w)
            sd[p + "mlp.c_fc.weight"] = rand(inter, w, scale=0.15)
            sd[p + "mlp.c_fc.bias"] = rand(inter)
            sd[p + "mlp.c_proj.weight"] = rand(w, inter, scale=0.1)
            sd[p + "mlp.c_proj.bias"] = rand(w)
    if text_prefix:
        sd = {(k if k.startswith("visual.") or k == "logit_scale" else "text." + k): v
              for k, v in sd.items()}
    return sd


def _oc_config(*, quick_gelu, head_width, heads=4, image=32, patch=8, proj=16):
    cfg = {"embed_dim": proj,
           "vision_cfg": {"image_size": image, "patch_size": patch, "layers": 2,
                          "width": 32, "head_width": head_width},
           "text_cfg": {"context_length": 77, "vocab_size": len(VOCAB), "width": 32,
                        "heads": heads, "layers": 2}}
    if quick_gelu:
        cfg["quick_gelu"] = True
    return {"model_cfg": cfg}


OC_CASES = [dict(quick_gelu=False, head_width=8), dict(quick_gelu=True, head_width=16),
            dict(quick_gelu=False, head_width=32, text_prefix=True)]


@pytest.mark.parametrize("case", OC_CASES, ids=["gelu_hw8", "quick_hw16", "text_prefix_hw32"])
def test_open_clip_conversion_equals_jax(case):
    case = dict(case)
    prefix = case.pop("text_prefix", False)
    sd = _open_clip_state(5, text_prefix=prefix)
    want = jax_convert_open_clip_state_dict(dict(sd))
    got = ckpt.convert_open_clip_state_dict(dict(sd))
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k].shape == tuple(np.shape(w)), k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(w), err_msg=k)

    oc = _oc_config(**case)
    flat = ckpt.strip_text_prefix(sd)
    hf = hf_clip_config_from_open_clip(oc, flat)
    spec = CLIPSpec.from_open_clip(oc, flat)
    t, v = hf.text_config, hf.vision_config
    assert dataclasses.asdict(spec) == dict(
        vocab_size=t.vocab_size, text_width=t.hidden_size, text_layers=t.num_hidden_layers,
        text_heads=t.num_attention_heads, text_mlp=t.intermediate_size,
        context_length=t.max_position_embeddings, text_act=t.hidden_act,
        text_layer_norm_eps=t.layer_norm_eps, eos_token_id=t.eos_token_id,
        vision_width=v.hidden_size, vision_layers=v.num_hidden_layers,
        vision_heads=v.num_attention_heads, vision_mlp=v.intermediate_size,
        num_channels=v.num_channels, image_size=v.image_size, patch_size=v.patch_size,
        vision_act=v.hidden_act, vision_layer_norm_eps=v.layer_norm_eps,
        projection_dim=hf.projection_dim)
    assert spec.vision_heads == 32 // case["head_width"]
    assert spec.vision_act == ("quick_gelu" if case["quick_gelu"] else "gelu")


def test_open_clip_unknown_and_missing_keys_raise(tmp_path):
    sd = _open_clip_state(6)
    with pytest.raises(ValueError, match="unrecognized open_clip keys"):
        ckpt.convert_open_clip_state_dict({**sd, "visual.unknown_thing": torch.zeros(3)})
    with pytest.raises(KeyError):
        ckpt.convert_open_clip_state_dict({k: v for k, v in sd.items() if k != "visual.proj"})
    # a spec that does not fit the weights raises in the encoder
    d = _write_open_clip_dir(tmp_path / "oc", sd, _oc_config(quick_gelu=False, head_width=8))
    with open(os.path.join(d, "open_clip_config.json")) as f:
        cfg = json.load(f)
    cfg["model_cfg"]["vision_cfg"]["image_size"] = 64
    with open(os.path.join(d, "open_clip_config.json"), "w") as f:
        json.dump(cfg, f)
    with pytest.raises(ValueError, match="does not fit its config"):
        HFCLIPEncoder(d, device="cpu")


def test_clip_spec_from_hf_config_defaults(tmp_path):
    (tmp_path / "config.json").write_text("{}")
    spec = CLIPSpec.from_hf_config(str(tmp_path / "config.json"))
    t, v = transformers.CLIPTextConfig(), transformers.CLIPVisionConfig()
    assert (spec.vocab_size, spec.text_width, spec.text_act, spec.eos_token_id,
            spec.vision_width, spec.patch_size, spec.vision_act, spec.projection_dim) == \
        (t.vocab_size, t.hidden_size, t.hidden_act, t.eos_token_id, v.hidden_size,
         v.patch_size, v.hidden_act, transformers.CLIPConfig().projection_dim)
    legacy = {"text_config": {"hidden_size": 64}, "text_config_dict": {"hidden_size": 96},
              "projection_dim": 8}
    assert CLIPSpec.from_hf_dict(legacy).text_width == \
        transformers.CLIPConfig(**legacy).text_config.hidden_size == 96
    with pytest.raises(ValueError, match="activation"):
        CLIPSpec(text_act="relu")
    with pytest.raises(ValueError, match="heads"):
        CLIPSpec(text_width=30, text_heads=4)


# ---------------------------------------------------------------------------
# 5. the encoder against the JAX package's
# ---------------------------------------------------------------------------


def _write_open_clip_dir(d, sd, oc_config):
    d.mkdir(parents=True, exist_ok=True)
    torch.save(sd, str(d / "open_clip_pytorch_model.bin"))
    (d / "open_clip_config.json").write_text(json.dumps(oc_config))
    _write_tiny_tokenizer(d)
    transformers.CLIPImageProcessor(size={"shortest_edge": 32},
                                    crop_size={"height": 32, "width": 32}).save_pretrained(str(d))
    return str(d)


def _inputs():
    rng = np.random.default_rng(11)
    images = [rng.integers(0, 256, s, dtype=np.uint8)
              for s in ((40, 50, 3), (32, 32, 3), (97, 61, 3), (12, 12, 3), (224, 224, 3))]
    texts = ["lower", "newer", "wider lowest", "", "a chair", "lower " * 20, "LOW-er!"]
    return images, texts


def _assert_encoders_agree(jax_enc, port, layout):
    images, texts = _inputs()
    assert port.layout == layout and port.feature_dim == jax_enc.feature_dim == 16
    assert all(p.device.type == "cpu" and p.dtype == torch.float32
               for p in port.model.parameters())
    for want, got in ((jax_enc.encode_images(images), port.encode_images(images)),
                      (jax_enc.encode_texts(texts), port.encode_texts(texts))):
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=FEATURE_ATOL)
        np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("layout", ["flax", "torch", "safetensors"])
def test_encoder_equals_jax_hf_layouts(hf_dirs, layout, monkeypatch):
    if layout == "flax":
        d = hf_dirs["all"]
        jax_enc = JaxHFCLIPEncoder(d)
        assert jax_enc._flax
    else:
        d = hf_dirs[layout]
        # the JAX torch fallback, as tests/test_semantics_hfclip.py forces it

        def no_flax(*a, **k):
            raise OSError("flax disabled for test")

        monkeypatch.setattr(transformers.FlaxCLIPModel, "from_pretrained",
                            staticmethod(no_flax))
        jax_enc = JaxHFCLIPEncoder(d)
        assert jax_enc._torch
    port = HFCLIPEncoder(d, device="cpu")
    assert port.model.spec.eos_token_id == (hf_dirs["eos"] or 49407)
    _assert_encoders_agree(jax_enc, port, layout)


@pytest.mark.parametrize("case", OC_CASES[:2], ids=["gelu_hw8", "quick_hw16"])
def test_encoder_equals_jax_open_clip_layout(tmp_path, case):
    d = _write_open_clip_dir(tmp_path / "oc", _open_clip_state(7), _oc_config(**case))
    _assert_encoders_agree(JaxHFCLIPEncoder(d), HFCLIPEncoder(d, device="cpu"), "open_clip")


def test_text_pooling_rules(hf_dirs):
    """Both pooling rules against HF's text model on ids where the EOS id
    occurs, twice, and nowhere."""
    d = hf_dirs["all"]
    port = HFCLIPEncoder(d, device="cpu")
    hf = transformers.CLIPModel.from_pretrained(d, local_files_only=True).eval()
    ids = torch.tensor([[21, 15, 16, 22, 22], [21, 3, 22, 4, 22], [21, 3, 4, 5, 6]])
    with torch.no_grad():
        want = hf.get_text_features(input_ids=ids)
        got = port.model.get_text_features(ids)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)
    pos = port.model.text_model.pool_positions(ids).tolist()
    assert pos == ([3, 2, 0] if hf_dirs["eos"] == 2 else [0, 0, 0])


def test_encoder_refusals(tmp_path, hf_dirs):
    with pytest.raises(ValueError, match="context length"):
        HFCLIPEncoder(hf_dirs["all"], device="cpu").encode_texts(["lower " * 80])
    # an open_clip checkpoint without its tokenizer files: the JAX message
    d = tmp_path / "bare"
    d.mkdir()
    torch.save(_open_clip_state(8), str(d / "open_clip_pytorch_model.bin"))
    (d / "open_clip_config.json").write_text(json.dumps(_oc_config(quick_gelu=False,
                                                                   head_width=8)))
    with pytest.raises(ValueError, match="no tokenizer/preprocessor files") as port:
        HFCLIPEncoder(str(d), device="cpu")
    with pytest.raises(ValueError, match="no tokenizer/preprocessor files"):
        JaxHFCLIPEncoder(str(d))
    assert isinstance(port.value.__cause__, OSError)
    # the refusals of a missing checkpoint, by the class transformers raises
    with pytest.raises(ValueError):
        HFCLIPEncoder("/no/such/clip", device="cpu")
    with pytest.raises(OSError):
        HFCLIPEncoder("no-such-org/no-such-clip", device="cpu")


def test_encoder_resolves_a_hub_cache_snapshot(hf_dirs, tmp_path, monkeypatch):
    """A repo id loads from the local hub cache (refs/main -> snapshot), as
    ``from_pretrained(..., local_files_only=True)`` does; nothing is fetched."""
    repo = tmp_path / "hub" / "models--org--tiny-clip"
    (repo / "refs").mkdir(parents=True)
    (repo / "refs" / "main").write_text("abc123\n")
    shutil.copytree(hf_dirs["torch"], repo / "snapshots" / "abc123")
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    assert ckpt.resolve_checkpoint_dir("org/tiny-clip") == str(repo / "snapshots" / "abc123")
    enc = HFCLIPEncoder("org/tiny-clip", device="cpu")
    want = HFCLIPEncoder(hf_dirs["torch"], device="cpu")
    images, texts = _inputs()
    np.testing.assert_array_equal(enc.encode_images(images), want.encode_images(images))
    np.testing.assert_array_equal(enc.encode_texts(texts), want.encode_texts(texts))
    with pytest.raises(OSError, match="not in the hub"):
        ckpt.resolve_checkpoint_dir("org/other-clip")


def test_tf32_is_refused_on_the_card(monkeypatch):
    """The refusal reads only the process's flags, so it runs here with a
    CUDA device object and no card."""
    from maskclustering_tpu_torch.device import check_full_float32

    card = torch.device("cuda", 0)
    check_full_float32(card, "the CLIP encoder")
    check_full_float32(torch.device("cpu"), "the CLIP encoder")
    monkeypatch.setattr(torch, "get_float32_matmul_precision", lambda: "high")
    with pytest.raises(RuntimeError, match="the CLIP encoder needs full float32"):
        check_full_float32(card, "the CLIP encoder")
    with pytest.raises(RuntimeError, match="TF32"):
        HFCLIPEncoder("/no/such/clip", device=card)


# ---------------------------------------------------------------------------
# 6. the batch driver's default steps
# ---------------------------------------------------------------------------


def test_driver_default_steps_with_clip_equal_jax(tmp_path, hf_dirs):
    from maskclustering_tpu.config import load_config as jax_load_config
    from maskclustering_tpu.run import DEFAULT_STEPS as JAX_DEFAULT_STEPS
    from maskclustering_tpu.run import evaluate_step as jax_evaluate_step
    from maskclustering_tpu.run import run_pipeline as jax_run_pipeline
    from maskclustering_tpu.utils.synthetic import make_scene, write_scannet_layout
    from maskclustering_tpu_torch.config import load_config
    from maskclustering_tpu_torch.run import DEFAULT_STEPS, run_pipeline

    assert DEFAULT_STEPS == JAX_DEFAULT_STEPS
    name = "scene0042_00"
    kw = dict(config_name="cliprun", step=1, distance_threshold=0.05, mask_pad_multiple=32)
    roots = {}
    for side in ("jax", "port"):
        roots[side] = str(tmp_path / side)
        write_scannet_layout(make_scene(num_boxes=3, num_frames=8, image_hw=(60, 80), seed=7),
                             roots[side], name)
    spec = f"hf:{hf_dirs['all']}"
    jax_cfg = jax_load_config("scannet").replace(data_root=roots["jax"], **kw)
    jx = jax_run_pipeline(jax_cfg, [name], encoder_spec=spec, resume=False)
    port = run_pipeline(load_config("scannet", data_root=roots["port"], **kw), [name],
                        encoder_spec=spec, resume=False, device="cpu")
    assert not jx.step_errors and not port.step_errors, (jx.step_errors, port.step_errors)
    assert [s.status for s in port.scenes] == ["ok"]

    def artifacts(root):
        od = os.path.join(root, "scannet", "processed", name, "output", "object", "cliprun")
        feats = np.load(os.path.join(od, "open-vocabulary_features.npy"),
                        allow_pickle=True).item()
        labels = np.load(os.path.join(root, "text_features", "scannet.npy"),
                         allow_pickle=True).item()
        with np.load(os.path.join(root, "prediction", "cliprun", f"{name}.npz")) as z:
            npz = {k: z[k] for k in z.files}
        return feats, labels, npz

    (jf, jl, jn), (pf, pl, pn) = artifacts(roots["jax"]), artifacts(roots["port"])
    assert list(pf) == list(jf) and pf
    for k in jf:
        assert pf[k].shape == jf[k].shape == (16,) and pf[k].dtype == np.float32
        np.testing.assert_allclose(pf[k], jf[k], rtol=0, atol=FEATURE_ATOL, err_msg=k)
    assert list(pl) == list(jl)
    for k in jl:
        np.testing.assert_allclose(pl[k], jl[k], rtol=0, atol=FEATURE_ATOL, err_msg=k)
    assert sorted(pn) == sorted(jn)
    for k in jn:
        assert pn[k].dtype == jn[k].dtype, k
        np.testing.assert_array_equal(pn[k], jn[k], err_msg=k)
    want_ap = jax_evaluate_step(jax_cfg, no_class=False, seq_names=[name])
    got_ap = port.evaluation["eval"]
    assert json.dumps(got_ap, sort_keys=True, default=str) == \
        json.dumps(want_ap, sort_keys=True, default=str)
