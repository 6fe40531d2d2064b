"""Block smoothing of progressive JPEG whose scans stop early, against cv2
and PIL.

libjpeg-turbo estimates the coefficients 1-9 that a component never
received in full from the DC values of each block's 5x5 neighbourhood, and
the DC too when no AC data arrived (``jdcoefct.c``); PIL and cv2 both
decode so. The files are PIL's progressive files (its ten-scan script),
cv2's, their arithmetic transcodes and a custom script's, cut after every
scan count before the last; odd sizes and both usual subsamplings, so the
window meets the image's edges, a component two blocks wide, the MCU
grid's padding rows and an iMCU row shorter than its component's sampling.
"""

import io

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

import jpeg_writers as W
from maskclustering_tpu_torch.io import jpeg, jpeg_smooth

# one intra-op thread: the suite runs in parallel worker processes
torch.set_num_threads(1)


def _pil(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _assert_like_pil_and_cv2(data):
    want_pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    got = jpeg.decode_jpeg(data)
    got = got if got.ndim == 3 else np.repeat(got[:, :, None], 3, axis=2)
    np.testing.assert_array_equal(got, want_pil)
    np.testing.assert_array_equal(got, bgr[:, :, ::-1])


@pytest.mark.parametrize("keep", range(1, 10))
def test_progressive_file_that_libjpeg_smooths_decodes_like_pil_and_cv2(keep):
    """PIL's q85 40x56 progressive file cut after 1-9 of its ten scans, as
    Huffman and arithmetic-coded (the shipped file of chip_smoke's phase 23)."""
    with open(f"{W.KINDS_DIR}/pil_progressive_q85_40x56.jpg", "rb") as f:
        data = f.read()
    assert len(W.scan_starts(data)) == 10
    for src in (data, W.transcode_arith(data)):
        cut = W.cut_after(src, keep)
        frame = jpeg._parse(cut, "cut")
        comps = frame.comps
        assert jpeg_smooth.smoothing_ok([c.quant for c in comps],
                                        [frame.coef_bits[c.cid][:10] for c in comps])
        _assert_like_pil_and_cv2(cut)


@pytest.mark.parametrize("keep", range(1, 10))
@pytest.mark.parametrize("sub", [0, 2], ids=["444", "420"])
@pytest.mark.parametrize("hw", [(37, 53), (9, 17), (1, 1), (17, 8), (33, 20)],
                         ids=lambda s: "x".join(map(str, s)))
def test_cut_pil_progressive_files_decode_like_pil_and_cv2(hw, sub, keep):
    data = _pil(W.photo(*hw, seed=keep + sub), quality=85, progressive=True, subsampling=sub)
    _assert_like_pil_and_cv2(W.cut_after(data, keep))


@pytest.mark.parametrize("keep", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("hw", [(16, 16), (8, 24), (45, 61)], ids=lambda s: "x".join(map(str, s)))
def test_cut_grey_progressive_files_decode_like_pil_and_cv2(hw, keep):
    """One component: libjpeg's six-scan script for it."""
    data = _pil(W.photo(*hw, seed=keep)[:, :, 0], quality=80, progressive=True)
    _assert_like_pil_and_cv2(W.cut_after(data, keep))


@pytest.mark.parametrize("params", ["default", "422", "444"])
def test_cut_cv2_progressive_files_decode_like_pil_and_cv2(params):
    extra = {"default": [], "422": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                    cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422],
             "444": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                     cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444]}[params]
    ok, buf = cv2.imencode(".jpg", W.photo(29, 43, seed=3)[:, :, ::-1],
                           [cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_QUALITY, 88] + extra)
    data = buf.tobytes()
    for keep in range(1, len(W.scan_starts(data))):
        _assert_like_pil_and_cv2(W.cut_after(data, keep))


@pytest.mark.parametrize("hw", [(37, 53), (9, 17), (24, 40)], ids=lambda s: "x".join(map(str, s)))
def test_cut_arithmetic_custom_script_decodes_like_pil_and_cv2(hw):
    """The custom script's scans (DC alone a component at Al 2, then
    refinements and bands) arithmetic-coded with restarts, cut after each:
    components no scan reached (libjpeg gives them 128 and smooths
    nothing), the DC known only in part, bands 1-9 at Al 1, a component
    without AC."""
    src = jpeg.encode_jpeg(W.photo(*hw, seed=5), 88)
    data = W.transcode_arith(src, progressive=True, script=W.custom_progression(3), restart=2)
    for keep in range(1, len(W.scan_starts(data))):
        _assert_like_pil_and_cv2(W.cut_after(data, keep))


def test_whole_files_and_dc_short_files_are_not_smoothed():
    """``smoothing_ok``: no smoothing once coefficients 1-9 are whole, nor
    while some component's DC is missing, nor for a zero quantiser."""
    data = _pil(W.photo(24, 32, seed=1), quality=85, progressive=True)
    frame = jpeg._parse(data, "whole")
    quants = [c.quant for c in frame.comps]
    bits = [frame.coef_bits[c.cid][:10] for c in frame.comps]
    assert not jpeg_smooth.smoothing_ok(quants, bits)
    short = [[-1] * 10] + bits[1:]
    assert not jpeg_smooth.smoothing_ok(quants, short)
    some = [[0, 1] + [0] * 8] + bits[1:]
    assert jpeg_smooth.smoothing_ok(quants, some)
    zero = [q.copy() for q in quants]
    zero[0][8] = 0
    assert not jpeg_smooth.smoothing_ok(zero, some)
