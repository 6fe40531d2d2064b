"""Arithmetic-coded JPEG (SOF9, SOF10) in the port's decoder, against cv2
and PIL.

The files are arithmetic transcodes of Huffman files (``jpeg_writers.
transcode_arith``, ``jpegtran -arithmetic`` on ``jcarith.c``'s model):
PIL's and cv2's own files and the port's encoder's, sequential or
progressive (PIL's ten-scan script and a custom one), with and without DAC
conditioning and restart intervals. cv2 and PIL must decode each transcode
to its Huffman original's pixels (which makes the file valid apart from
the port), and the port must decode it to the same pixels on both
readers. A cut stream raises ``ValueError``, as does a magnitude that
overflows 15 bits. PIL cannot feed libjpeg's arithmetic decoder past its
65536-byte read block, and the PIL route refuses exactly those files.
"""

import io

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


def _pil(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _libs(data):
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    assert bgr is not None
    return pil, bgr[:, :, ::-1]


def _source(kind, hw):
    img = W.photo(*hw, seed=sum(hw) + len(kind))
    return {
        "pil-420": lambda: _pil(img, quality=85),
        "pil-444": lambda: _pil(img, quality=92, subsampling=0),
        "pil-grey": lambda: _pil(img[:, :, 1], quality=80),
        "pil-prog-420": lambda: _pil(img, quality=85, progressive=True),
        "port-420": lambda: jpeg.encode_jpeg(img, 90),
        "cv2-411": lambda: cv2.imencode(".jpg", img[:, :, ::-1], [
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411])[1].tobytes(),
    }[kind]()


_CODINGS = {
    "sequential": {"progressive": False},
    "sequential-dac": {"progressive": False, "dac": {0: (2, 5, 3), 1: (0, 3, 10)}},
    "sequential-restart": {"progressive": False, "restart": 3},
    "progressive": {"progressive": True},
    "progressive-custom-dac-restart": {"progressive": True, "script": "custom",
                                       "dac": {0: (1, 1, 1), 1: (0, 4, 63)}, "restart": 2},
}


def _transcode(src, coding):
    kw = dict(_CODINGS[coding])
    if kw.get("script") == "custom":
        kw["script"] = W.custom_progression(len(W.read_frame(src).comps))
    return W.transcode_arith(src, **kw)


@pytest.mark.parametrize("hw", _SIZES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("coding", list(_CODINGS))
@pytest.mark.parametrize("source", ["pil-420", "pil-444", "pil-grey", "pil-prog-420",
                                    "port-420", "cv2-411"])
def test_arithmetic_transcodes_decode_like_pil_and_cv2(source, coding, hw):
    src = _source(source, hw)
    data = _transcode(src, coding)
    assert jpeg._parse(data, "t").arithmetic
    want_pil, want_cv2 = _libs(src)
    got_pil, got_cv2 = _libs(data)
    # the transcode is valid apart from the port: both libraries give the
    # Huffman original's pixels
    np.testing.assert_array_equal(got_pil, want_pil)
    np.testing.assert_array_equal(got_cv2, want_cv2)
    for reader, want in (("pil", got_pil), ("cv2", got_cv2)):
        got = jpeg.decode_jpeg(data, reader=reader)
        got = got if got.ndim == 3 else np.repeat(got[:, :, None], 3, axis=2)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("restart", [0, 1])
def test_arithmetic_dense_coefficients_decode_like_pil_and_cv2(restart):
    """Quality 100 over noise: long magnitudes from both X2 bins (Kx 0 and
    63), a restart at every MCU."""
    img = W.photo(48, 64, seed=9, noise=60.0)
    src = _pil(img, quality=100, subsampling=0)
    for kx in (0, 63):
        data = W.transcode_arith(src, dac={0: (0, 15, kx), 1: (15, 15, kx)}, restart=restart)
        got_pil, got_cv2 = _libs(data)
        np.testing.assert_array_equal(got_pil, _libs(src)[0])
        np.testing.assert_array_equal(jpeg.decode_jpeg(data), got_pil)
        np.testing.assert_array_equal(jpeg.decode_jpeg(data), got_cv2)


@pytest.mark.parametrize("cut", [0.3, 0.6, 0.95])
def test_truncated_arithmetic_files_raise(cut):
    src = _pil(W.photo(64, 96, seed=2), quality=90)
    for progressive in (False, True):
        data = W.transcode_arith(src, progressive=progressive, restart=4)
        with pytest.raises(ValueError, match="truncated"):
            jpeg.decode_jpeg(data[:int(len(data) * cut)], name="cut.jpg")
    with pytest.raises(ValueError, match="truncated"):
        jpeg.decode_jpeg(data[:-2], name="no-eoi.jpg")


def test_corrupt_arithmetic_streams_raise():
    """A DC magnitude of 16 bits (libjpeg warns and stops decoding the
    interval; the port refuses the file), a DAC value with L above U, and
    a restart interval missing."""
    f = W.frame_from_planes([np.zeros((8, 8), np.uint8)], [(1, 1)], [np.ones(64, np.int64)])
    f.coef[0][0, 0, 0] = 1 << 16
    with pytest.raises(ValueError, match="overflows"):
        jpeg.decode_jpeg(W.write_arith(f))
    data = W.transcode_arith(_pil(W.photo(16, 16, seed=1)))
    i = data.index(b"\xff\xc9")
    with pytest.raises(ValueError, match="DAC"):
        jpeg.decode_jpeg(data[:i] + b"\xff\xcc\x00\x04\x00\x23" + data[i:])
    data = W.transcode_arith(_pil(W.photo(32, 32, seed=1)), restart=1)
    j = data.index(b"\xff\xd1")
    k = data.index(b"\xff\xd2")
    with pytest.raises(ValueError, match="restart intervals"):
        jpeg.decode_jpeg(data[:j] + data[k:])


def _padded(data, n):
    """``data`` with COM segments of ``n`` bytes in all after SOI."""
    out = []
    while n > 0:
        size = min(n, 65537)
        if 0 < n - size < 4:
            size = n - 4
        out.append(b"\xff\xfe" + (size - 2).to_bytes(2, "big") + bytes(size - 4))
        n -= size
    return data[:2] + b"".join(out) + data[2:]


@pytest.mark.parametrize("shift,pil_reads", [(-300, False), (-2, True), (-1, False), (0, False),
                                             (2, False), (5000, True), (66000, False)])
def test_pil_route_refuses_what_pil_cannot_feed_the_arithmetic_decoder(tmp_path, shift,
                                                                      pil_reads):
    """PIL hands libjpeg a file 65536 bytes at a time, the next block only
    when libjpeg suspends; libjpeg's arithmetic decoder cannot suspend, so
    PIL fails on a file whose arithmetic interval reads past the blocks it
    had when the interval began. COM padding moves byte 65536 across the
    fourth scan's start: the PIL route refuses exactly where PIL fails,
    and the cv2 route (``cv2.imread`` reads the whole file) reads every
    case. Cases: the third scan's data or the decoder's look at the marker
    after it crossing the edge (PIL fails), the fourth scan's header
    crossing it (PIL suspends there and reads on), all the data past it in
    the second block, a scan crossing the second block's edge."""
    data = W.transcode_arith(jpeg.encode_jpeg(W.photo(120, 160, seed=3, noise=25), 90),
                             progressive=True, restart=5)
    data = _padded(data, 65536 - W.scan_starts(data)[3] + shift)
    path = tmp_path / "padded.jpg"
    path.write_bytes(data)
    try:
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except OSError:
        want = None
    if want is None:
        for read in (lambda: image.read_rgb_pil(str(path)), lambda: image.decode_rgb(data)):
            with pytest.raises(NotImplementedError, match="65536"):
                read()
    else:
        np.testing.assert_array_equal(image.read_rgb_pil(str(path)), want)
        np.testing.assert_array_equal(image.decode_rgb(data), want)
    np.testing.assert_array_equal(image.read_rgb(str(path)), jax_image.read_rgb(str(path)))
    assert (want is not None) == pil_reads
