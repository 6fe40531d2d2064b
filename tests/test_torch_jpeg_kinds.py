"""The JPEG kinds beyond Huffman YCbCr and greyscale on the port's two colour
routes, against the JAX package's readers.

``io/image.read_rgb`` must give the JAX ``read_rgb`` (``cv2.imread``, BGR
to RGB, the EXIF turn) and ``read_rgb_pil`` and ``decode_rgb`` PIL's
``Image.open(...).convert("RGB")``, pixel for pixel: CMYK (PIL's files,
with and without an Adobe segment) and YCCK (Adobe transform 2), whose
CMYK each library turns into RGB its own way; every integral sampling
ratio (libjpeg's box replication beyond h2v1, h1v2 and h2v2); lossless
files (predictors 1-7, point transforms, restart intervals, 1, 3 and 4
components, subsampled), which cv2 refuses in greyscale. What both
libraries refuse the port refuses on both routes (``test_torch_jpeg.py``).
``tests/jpeg_kinds/goldens.json`` is recomputed here from cv2 and
PIL, and the port is held to it as chip_smoke's phase 23 holds it.
"""

import io
import json

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

import jpeg_writers as W
from maskclustering_tpu.io import image as jax_image
from maskclustering_tpu_torch.io import image, jpeg

# one intra-op thread: the suite runs in parallel worker processes
torch.set_num_threads(1)

_SIZES = [(37, 53), (9, 17), (1, 1)]
_ids = lambda s: "x".join(map(str, s))  # noqa: E731


def _assert_routes(tmp_path, data, cv2_refuses=False):
    """``read_rgb`` against the JAX ``read_rgb``; ``read_rgb_pil`` and
    ``decode_rgb`` against PIL. Returns the PIL route's pixels."""
    path = str(tmp_path / "frame.jpg")
    with open(path, "wb") as f:
        f.write(data)
    want_pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    for got in (image.read_rgb_pil(path), image.decode_rgb(data)):
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want_pil)
    if cv2_refuses:
        with pytest.raises(FileNotFoundError):
            jax_image.read_rgb(path)
        with pytest.raises(NotImplementedError, match="cv2"):
            image.read_rgb(path)
    else:
        np.testing.assert_array_equal(image.read_rgb(path), jax_image.read_rgb(path))
    return want_pil


# ---------------------------------------------------------------------------
# four components
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quality", [75, 95])
@pytest.mark.parametrize("hw", _SIZES + [(64, 96)], ids=_ids)
def test_pil_cmyk_files_on_both_routes(tmp_path, hw, quality):
    """PIL's CMYK files (Adobe transform 0, stored inverted): cv2's and
    PIL's CMYK-to-RGB differ by up to 2, and each route gives its own."""
    buf = io.BytesIO()
    Image.fromarray(W.photo(*hw, seed=quality, channels=4), "CMYK").save(
        buf, format="JPEG", quality=quality)
    data = buf.getvalue()
    pil = _assert_routes(tmp_path, data)
    if hw == (64, 96):
        diff = np.abs(pil.astype(int) - jax_image.read_rgb(str(tmp_path / "frame.jpg")))
        assert 0 < diff.max() <= 2


@pytest.mark.parametrize("kind", ["no-adobe", "adobe-1", "arith-prog"])
def test_other_cmyk_files_on_both_routes(tmp_path, kind):
    """A CMYK file without its Adobe segment (libjpeg takes CMYK, PIL still
    inverts), four components under Adobe transform 1 (libjpeg takes YCCK),
    and PIL's CMYK arithmetic-coded progressive."""
    with open(f"{W.KINDS_DIR}/pil_cmyk_q90_37x53.jpg", "rb") as f:
        cmyk = f.read()
    frame = W.read_frame(cmyk)
    if kind == "no-adobe":
        frame.head = b""
        data = W.write_huffman(frame)
    elif kind == "adobe-1":
        frame.head = W.adobe(1)
        data = W.write_huffman(frame)
    else:
        data = W.write_arith(frame, progressive=True, script=W.simple_progression(4))
    _assert_routes(tmp_path, data)


@pytest.mark.parametrize("factors", [[(1, 1)] * 4, [(2, 2), (1, 1), (1, 1), (2, 2)],
                                     [(2, 1), (1, 1), (1, 1), (2, 1)]],
                         ids=["1111", "2112", "2-1-1-2h"])
@pytest.mark.parametrize("hw", _SIZES, ids=_ids)
def test_ycck_files_on_both_routes(tmp_path, hw, factors):
    """Adobe transform 2: ``ycck_cmyk_convert`` then each route's CMYK to
    RGB; Huffman and arithmetic-coded."""
    ink = W.photo(*hw, seed=len(factors) + hw[0], channels=4)
    planes = W.subsampled(np.stack(W.cmyk_to_ycck(ink), -1).clip(0, 255).astype(np.uint8),
                          factors)
    q = jpeg.quant_tables(88)
    frame = W.frame_from_planes(planes, factors, [q[0], q[1], q[1], q[0]], head=W.adobe(2),
                                size=hw)
    _assert_routes(tmp_path, W.write_huffman(frame))
    _assert_routes(tmp_path, W.write_arith(frame, restart=2))


# ---------------------------------------------------------------------------
# sampling ratios
# ---------------------------------------------------------------------------

_RATIOS = [[(4, 1), (1, 1), (1, 1)], [(3, 1), (1, 1), (1, 1)], [(1, 3), (1, 1), (1, 1)],
           [(3, 2), (1, 1), (1, 1)], [(2, 3), (1, 1), (1, 1)], [(4, 2), (1, 1), (1, 1)],
           [(2, 4), (1, 1), (1, 1)], [(1, 4), (1, 1), (1, 1)], [(1, 2), (1, 1), (1, 1)],
           [(2, 2), (2, 1), (1, 2)], [(4, 1), (2, 1), (2, 1)], [(2, 2), (1, 2), (1, 2)],
           [(1, 1), (2, 2), (1, 1)]]


@pytest.mark.parametrize("factors", _RATIOS,
                         ids=lambda f: "-".join(f"{h}{v}" for h, v in f))
@pytest.mark.parametrize("hw", _SIZES, ids=_ids)
def test_integral_sampling_ratios_on_both_routes(tmp_path, hw, factors):
    """Box replication for every ratio but h2v1, h1v2 and h2v2 (fancy), as
    ``jdsample.c`` chooses by each component's ratio to the largest
    factors; a component may be the largest in one axis only."""
    q = jpeg.quant_tables(85)
    frame = W.frame_from_planes(W.subsampled(W.photo(*hw, seed=4), factors), factors,
                                [q[0], q[1], q[1]], size=hw)
    _assert_routes(tmp_path, W.write_huffman(frame))
    if hw == (37, 53):
        _assert_routes(tmp_path, W.write_arith(frame, progressive=True))


@pytest.mark.parametrize("factor", ["411", "422", "440"])
def test_cv2_sampling_files_on_both_routes(tmp_path, factor):
    value = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{factor}")
    ok, buf = cv2.imencode(".jpg", W.photo(45, 61, seed=3)[:, :, ::-1],
                           [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, value])
    assert ok
    _assert_routes(tmp_path, buf.tobytes())


# ---------------------------------------------------------------------------
# lossless
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pt,rows", [(0, 0), (2, 3), (5, 1)], ids=["pt0", "pt2-rst3", "pt5-rst1"])
@pytest.mark.parametrize("predictor", range(1, 8))
@pytest.mark.parametrize("hw", _SIZES, ids=_ids)
def test_lossless_greyscale_on_the_pil_route(tmp_path, hw, predictor, pt, rows):
    """PIL reads 8-bit lossless greyscale exactly; cv2.imread asks libjpeg
    for BGR, which libjpeg-turbo refuses for a lossless greyscale file, so
    the JAX read_rgb raises and the port's read_rgb refuses."""
    grey = W.photo(*hw, seed=predictor)[:, :, 0]
    got = _assert_routes(tmp_path, W.write_lossless([grey], predictor, pt, rows),
                         cv2_refuses=True)
    np.testing.assert_array_equal(got[:, :, 0], (grey >> pt) << pt)


@pytest.mark.parametrize("kind", ["rgb-ids", "rgb-123", "adobe-0", "cmyk", "rgb-separate-scans",
                                  "sub-22", "sub-21-separate", "sub-41", "sub-12"])
@pytest.mark.parametrize("hw", _SIZES, ids=_ids)
def test_lossless_colour_on_both_routes(tmp_path, hw, kind):
    """Three components without a JFIF segment are RGB to a lossless
    libjpeg (ids 'R', 'G', 'B' or any other), read by both; four are CMYK;
    subsampled components are box-replicated, their MCU padding dropped."""
    img = W.photo(*hw, seed=len(kind))
    planes = [img[:, :, k] for k in range(3)]
    kw = {"predictor": 1 + len(kind) % 7, "pt": len(kind) % 3, "restart_rows": len(kind) % 3}
    if kind.startswith("sub"):
        factors = {"sub-22": [(2, 2), (1, 1), (1, 1)], "sub-21-separate": [(2, 1), (1, 1), (1, 1)],
                   "sub-41": [(4, 1), (1, 1), (1, 1)], "sub-12": [(1, 2), (1, 1), (1, 1)]}[kind]
        kw.update(factors=factors, size=hw, interleave="separate" not in kind)
        planes = W.subsampled(img, factors)
    data = {
        "rgb-ids": lambda: W.write_lossless(planes, ids=[82, 71, 66], **kw),
        "rgb-123": lambda: W.write_lossless(planes, **kw),
        "adobe-0": lambda: W.write_lossless(planes, head=W.adobe(0), **kw),
        "cmyk": lambda: W.write_lossless(planes + [img[:, :, 0]], **kw),
        "rgb-separate-scans": lambda: W.write_lossless(planes, interleave=False, **kw),
    }.get(kind, lambda: W.write_lossless(planes, ids=[82, 71, 66], **kw))()
    got = _assert_routes(tmp_path, data)
    if kind in ("rgb-ids", "rgb-123", "rgb-separate-scans"):
        np.testing.assert_array_equal(got, (img >> kw["pt"]) << kw["pt"])


@pytest.mark.parametrize("rows", [1, 2])
@pytest.mark.parametrize("factors", [[(1, 2)], [(2, 3)], [(1, 3), (1, 1), (1, 1)]],
                         ids=["grey-12", "grey-23", "rgb-13-separate"])
def test_lossless_restarts_inside_an_imcu_row(tmp_path, factors, rows):
    """A one-component scan of a component sampled v > 1 with a restart
    every ``rows`` < v rows: libjpeg undifferences an iMCU row after
    decoding all of it, so the first-row rule falls on that iMCU row's
    first row, not on the row where the interval starts (the writer codes
    the latter, so libjpeg's pixels are not the image; the port's must
    be libjpeg's)."""
    hw = (23, 31)
    planes = W.subsampled(W.photo(*hw, seed=rows, channels=3), factors)
    data = W.write_lossless(planes, 4, 0, rows, factors=factors, size=hw, interleave=False,
                            ids=[82, 71, 66][:len(factors)])
    _assert_routes(tmp_path, data, cv2_refuses=len(factors) == 1)


# ---------------------------------------------------------------------------
# the EXIF turn, the goldens
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("value", [3, 6, 8])
@pytest.mark.parametrize("kind", ["cmyk", "arith-prog", "lossless-rgb"])
def test_read_rgb_turns_the_new_kinds_by_their_exif_orientation(tmp_path, kind, value):
    """cv2.imread turns every kind by the EXIF orientation (C8's turn);
    PIL's route leaves it."""
    if kind == "cmyk":
        with open(f"{W.KINDS_DIR}/pil_cmyk_q90_37x53.jpg", "rb") as f:
            data = f.read()
    elif kind == "arith-prog":
        data = W.transcode_arith(jpeg.encode_jpeg(W.photo(37, 53, seed=value), 85),
                                 progressive=True)
    else:
        data = W.write_lossless([W.photo(37, 53, seed=value)[:, :, k] for k in range(3)], 4)
    _assert_routes(tmp_path, data)
    plain = image.read_rgb(str(tmp_path / "frame.jpg"))
    pil = _assert_routes(tmp_path, data[:2] + W.exif_orientation(value) + data[2:])
    turned = image.read_rgb(str(tmp_path / "frame.jpg"))
    np.testing.assert_array_equal(pil, image.decode_rgb(data))
    if value == 3:
        np.testing.assert_array_equal(turned, plain[::-1, ::-1])
    else:
        assert turned.shape == (plain.shape[1], plain.shape[0], 3)


def test_goldens_are_cv2_and_pil():
    """``tests/jpeg_kinds/goldens.json`` is what cv2 and PIL give today for
    every fixture (``python tests/jpeg_writers.py`` rewrites it)."""
    with open(W.GOLDENS) as f:
        goldens = json.load(f)
    assert W.record_goldens() == goldens
    assert sum(v["cv2"] == v["pil"] == "refused" for v in goldens.values()) >= 10
    assert any(v["cv2"] == "refused" != v["pil"] for v in goldens.values())


def test_port_matches_the_goldens():
    """What phase 23 checks on the card's machine, here: every fixture's
    bytes, ``read_rgb`` against the cv2 golden, ``read_rgb_pil`` and
    ``decode_rgb`` against PIL's, each refusal raised."""
    with open(W.GOLDENS) as f:
        goldens = json.load(f)
    ms = W.port_against_goldens(goldens)
    assert sorted(ms) == sorted(goldens)


def test_chip_smoke_kinds_check_runs_without_pil_cv2_or_jax(tmp_path):
    """``chip_smoke.py --jpeg-kinds OUT`` (phase 23's child) in a fresh
    interpreter: every fixture checked, decode times written, and neither
    PIL, cv2 nor JAX imported (the card's machine has none of them)."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(W.HERE)
    out = tmp_path / "kinds.json"
    code = (f"import sys; sys.path.insert(0, {repo!r}); import chip_smoke; "
            f"assert chip_smoke.jpeg_kinds({str(out)!r}) == 0; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('PIL', 'cv2', 'jax', 'maskclustering_tpu')); assert not bad, bad")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    with open(out) as f:
        ms = json.load(f)["ms"]
    with open(W.GOLDENS) as f:
        assert sorted(ms) == sorted(json.load(f))
