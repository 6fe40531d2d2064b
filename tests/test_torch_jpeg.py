"""The port's JPEG codec (``io/jpeg.py``) against PIL and cv2.

The decoder must give PIL's and cv2's pixels exactly (both run
libjpeg-turbo's default decode) on files written by PIL (qualities 50, 75
and 95; 4:4:4, 4:2:2 and 4:2:0; greyscale; restart intervals; the Adobe
RGB transform; odd sizes), by cv2 (its default, 4:4:4 and 4:4:0) and by
the port's own encoder; progressive files (SOF2) by PIL (with and without
``optimize``, 4:2:0, 4:4:4 and greyscale, restart markers) and cv2 (its
default, 4:4:4, 4:2:2, restart intervals), odd sizes 1x1 to 64x96. The
kinds that cv2 and PIL both refuse raise ``NotImplementedError`` on both
colour routes, each shown refused by both libraries on the same bytes;
truncated files raise ``ValueError``. The encoder writes libjpeg's tables
and stays within a PSNR floor of its source. Arithmetic coding, block
smoothing and the other kinds have files of their own
(``test_torch_jpeg_arith.py``, ``_smooth.py``, ``_kinds.py``).
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


def _photo(h, w, seed, noise=20.0):
    """A smooth gradient under seeded noise: dense AC coefficients."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1), (x + 2 * y) * 3 % 256],
                    axis=-1)
    return np.clip(base + rng.normal(0.0, noise, (h, w, 3)), 0, 255).astype(np.uint8)


def _pil(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _cv2(img, *params):
    ok, buf = cv2.imencode(".jpg", img[:, :, ::-1], list(params))
    assert ok
    return buf.tobytes()


def _assert_decodes_like_pil_and_cv2(data):
    got = jpeg.decode_jpeg(data)
    rgb = got if got.ndim == 3 else np.repeat(got[:, :, None], 3, axis=2)
    want_pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    want_cv2 = cv2.cvtColor(cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR),
                            cv2.COLOR_BGR2RGB)
    assert rgb.dtype == np.uint8 and rgb.shape == want_pil.shape
    np.testing.assert_array_equal(rgb, want_pil)
    np.testing.assert_array_equal(rgb, want_cv2)
    return got


@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
@pytest.mark.parametrize("hw", [(64, 96), (37, 53), (9, 17), (1, 1)], ids=lambda s: "x".join(
    map(str, s)))
def test_pil_files_decode_like_pil_and_cv2(quality, subsampling, hw):
    data = _pil(_photo(*hw, seed=quality + subsampling), quality=quality,
                subsampling=subsampling)
    assert _assert_decodes_like_pil_and_cv2(data).shape == hw + (3,)


@pytest.mark.parametrize("kind", ["grey", "grey-odd", "restart-blocks", "restart-rows",
                                  "adobe-rgb", "larger"])
def test_pil_file_kinds_decode_like_pil_and_cv2(kind):
    img = _photo(40, 56, seed=11)
    data = {
        "grey": lambda: _pil(img[:, :, 1]),
        "grey-odd": lambda: _pil(_photo(17, 9, seed=12)[:, :, 0], quality=95),
        "restart-blocks": lambda: _pil(img, quality=80, restart_marker_blocks=3),
        "restart-rows": lambda: _pil(_photo(37, 53, seed=13), restart_marker_rows=1),
        "adobe-rgb": lambda: _pil(img, quality=90, keep_rgb=True),
        "larger": lambda: _pil(_photo(480, 640, seed=14, noise=8.0), quality=90),
    }[kind]()
    got = _assert_decodes_like_pil_and_cv2(data)
    assert got.ndim == (2 if kind.startswith("grey") else 3)


@pytest.mark.parametrize("params", [(), (cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444),
                                    (cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                     cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440),
                                    (cv2.IMWRITE_JPEG_QUALITY, 60,
                                     cv2.IMWRITE_JPEG_RST_INTERVAL, 2)],
                         ids=["default", "444", "440", "q60-restart"])
def test_cv2_files_decode_like_pil_and_cv2(params):
    _assert_decodes_like_pil_and_cv2(_cv2(_photo(45, 61, seed=3), *params))


@pytest.mark.parametrize("hw,quality", [((64, 96), 75), ((37, 53), 90), ((17, 9), 50),
                                        ((16, 16), 100), ((2, 3), 75)])
def test_port_encoder_files_decode_like_pil_and_cv2(hw, quality):
    """The port's encoder is a third encoder the decoder is held on."""
    data = jpeg.encode_jpeg(_photo(*hw, seed=5), quality)
    assert _assert_decodes_like_pil_and_cv2(data).shape == hw + (3,)


def test_port_encoder_tables_and_fidelity():
    """libjpeg's quality-75 tables and the standard Huffman tables, as PIL
    writes them; a PSNR floor on a smooth image; 4:2:0 in the frame header."""
    def segments(data):
        out, i = {}, 2
        while data[i + 1] != 0xDA:
            length = int.from_bytes(data[i + 2:i + 4], "big")
            out.setdefault(data[i + 1], []).append(data[i + 4:i + 2 + length])
            i += 2 + length
        return out

    def huffman_tables(payloads):
        out, data = {}, b"".join(payloads)
        while data:
            n = 17 + sum(data[1:17])
            out[data[0]] = data[1:n]
            data = data[n:]
        return out

    img = _photo(48, 64, seed=6, noise=0.0)
    ours, pils = segments(jpeg.encode_jpeg(img)), segments(_pil(img, quality=75))
    assert b"".join(ours[0xDB]) == b"".join(pils[0xDB])
    assert huffman_tables(ours[0xC4]) == huffman_tables(pils[0xC4])
    assert len(huffman_tables(ours[0xC4])) == 4
    assert ours[0xC0] == pils[0xC0]  # 8 bits, 48x64, Y 2x2, Cb and Cr 1x1
    # a smooth image: within 0.5 dB of PIL's own file and above a floor
    y, x = np.mgrid[0:48, 0:64]
    smooth = np.stack([x * 255 // 63, y * 255 // 47, (x + y) * 255 // 110], -1).astype(np.uint8)

    def psnr(data):
        err = jpeg.decode_jpeg(data).astype(np.float64) - smooth
        return 10 * np.log10(255.0 ** 2 / np.mean(err ** 2))

    for quality, floor in ((75, 40.0), (90, 45.0)):
        ours = psnr(jpeg.encode_jpeg(smooth, quality))
        assert ours > floor and ours > psnr(_pil(smooth, quality=quality)) - 0.5, quality
    with pytest.raises(ValueError, match="uint8 RGB"):
        jpeg.encode_jpeg(img[:, :, 0])


def test_read_rgb_decodes_jpeg_like_the_jax_reader(tmp_path):
    """``io/image.read_rgb``: JPEG through the port's decoder, greyscale
    replicated to three channels, as the JAX package's cv2 reader gives."""
    for name, data in (("c.jpg", _pil(_photo(30, 41, seed=8))),
                       ("g.jpg", _pil(_photo(30, 41, seed=9)[:, :, 2])),
                       ("e.jpg", jpeg.encode_jpeg(_photo(30, 41, seed=10)))):
        (tmp_path / name).write_bytes(data)
        got = image.read_rgb(str(tmp_path / name))
        assert got.shape == (30, 41, 3)
        np.testing.assert_array_equal(got, jax_image.read_rgb(str(tmp_path / name)))
    (tmp_path / "x.gif").write_bytes(b"GIF89a" + bytes(40))
    with pytest.raises(ValueError, match="neither a JPEG nor a PNG"):
        image.read_rgb(str(tmp_path / "x.gif"))


def _assert_refused(tmp_path, data, match):
    """Both libraries refuse the bytes, and so does the port on each route."""
    path = str(tmp_path / "refused.jpg")
    with open(path, "wb") as f:
        f.write(data)
    assert cv2.imread(path) is None
    with pytest.raises(FileNotFoundError):
        jax_image.read_rgb(path)
    with pytest.raises(Exception):
        Image.open(io.BytesIO(data)).convert("RGB")
    for read in (lambda: image.read_rgb(path), lambda: image.read_rgb_pil(path),
                 lambda: image.decode_rgb(data, name="refused.jpg")):
        with pytest.raises(NotImplementedError, match=match) as err:
            read()
        assert "refused.jpg" in str(err.value) and "cv2 and PIL" in str(err.value)


def _patch_sof(data, marker):
    i = data.index(b"\xff\xc0")
    return data[:i + 1] + bytes([marker]) + data[i + 2:]


@pytest.mark.parametrize("kind,match", [
    ("12-bit", "12-bit"), ("sof5", "hierarchical"), ("sof6", "hierarchical"),
    ("sof7", "hierarchical"), ("sof13", "hierarchical"), ("sof14", "hierarchical"),
    ("sof15", "hierarchical"), ("dnl", "DNL"), ("2-component", "2-component"),
    ("5-component", "5-component"), ("fractional", "non-integral"),
    ("arithmetic-lossless", "arithmetic-coded lossless"), ("lossless-12-bit", "12-bit"),
    ("lossless-16-bit", "16-bit"), ("lossless-ycc", "lossless YCC"),
    ("lossless-ycck", "lossless YCCK")])
def test_unsupported_kinds_raise(tmp_path, kind, match):
    """Each kind still refused is refused by cv2 and PIL on the same bytes:
    12-bit samples (a full 12-bit writer: SOF1, tables built for its
    sizes), hierarchical frames, a height left to a DNL marker, 2 or 5
    components, a non-integral upsampling ratio, arithmetic-coded lossless
    and lossless files that would need a lossy colour conversion."""
    grey = W.photo(24, 32, seed=1)[:, :, 0]
    rgb = W.photo(24, 32, seed=2)
    q = jpeg.quant_tables(75)
    base = jpeg.encode_jpeg(rgb, 75)

    def twelve():
        f = W.frame_from_planes([grey], [(1, 1)], [q[0]])
        f.precision = 12
        f.coef = [c * 16 for c in f.coef]
        return W.write_huffman(f)

    def fractional():
        fac = [(3, 1), (2, 1), (1, 1)]
        return W.write_huffman(W.frame_from_planes(W.subsampled(rgb, fac), fac,
                                                   [q[0], q[1], q[1]], size=(24, 32)))

    i = base.index(b"\xff\xc0")
    data = {
        "12-bit": twelve,
        "dnl": lambda: base[:i + 5] + b"\x00\x00" + base[i + 7:],
        "2-component": lambda: W.write_huffman(W.frame_from_planes(
            [grey, grey], [(1, 1)] * 2, [q[0], q[1]])),
        "5-component": lambda: W.write_huffman(W.frame_from_planes(
            [grey] * 5, [(1, 1)] * 5, [q[0]] * 5)),
        "fractional": fractional,
        "arithmetic-lossless": lambda: W.write_lossless([grey], 1, marker=0xCB),
        "lossless-12-bit": lambda: W.write_lossless([grey.astype(np.int64) * 16], 2,
                                                    precision=12),
        "lossless-16-bit": lambda: W.write_lossless([grey.astype(np.int64) * 257], 3,
                                                    precision=16),
        "lossless-ycc": lambda: W.write_lossless([rgb[:, :, k] for k in range(3)], 1,
                                                 head=W.JFIF),
        "lossless-ycck": lambda: W.write_lossless([rgb[:, :, k] for k in (0, 1, 2, 0)], 1,
                                                  head=W.adobe(2)),
    }.get(kind, lambda: _patch_sof(base, 0xC0 + int(kind[3:])))()
    _assert_refused(tmp_path, data, match)


def test_mcu_of_more_than_ten_blocks_is_corrupt(tmp_path):
    """libjpeg's JERR_BAD_MCU_SIZE, which the standard forbids: a
    ``ValueError`` on both routes, and cv2 and PIL refuse it too."""
    q = jpeg.quant_tables(75)
    fac = [(3, 3), (1, 1), (1, 1)]
    data = W.write_huffman(W.frame_from_planes(W.subsampled(W.photo(24, 32, seed=3), fac), fac,
                                               [q[0], q[1], q[1]], size=(24, 32)))
    path = str(tmp_path / "big.jpg")
    with open(path, "wb") as f:
        f.write(data)
    assert cv2.imread(path) is None
    with pytest.raises(Exception):
        Image.open(io.BytesIO(data)).convert("RGB")
    for read in (lambda: image.read_rgb(path), lambda: image.decode_rgb(data)):
        with pytest.raises(ValueError, match="11 blocks"):
            read()


@pytest.mark.parametrize("cut", [0.3, 0.6, 0.95])
def test_truncated_files_raise(cut):
    data = _pil(_photo(64, 96, seed=2), quality=90)
    with pytest.raises(ValueError, match="truncated"):
        jpeg.decode_jpeg(data[:int(len(data) * cut)], name="cut.jpg")
    with pytest.raises(ValueError, match="truncated"):
        jpeg.decode_jpeg(data[:-2], name="no-eoi.jpg")  # the EOI marker gone
    with pytest.raises(ValueError, match="not a JPEG"):
        jpeg.decode_jpeg(b"\x89PNG" + data[4:])
    with pytest.raises(ValueError, match="corrupt JPEG"):
        jpeg.decode_jpeg(b"\xff\xd8\xff\xc0\x00\x03\x08\xff\xd9")  # a 1-byte frame header


def _grey_file(blocks, quant):
    """A one-row greyscale baseline file with the given (n, 64) zig-zag
    coefficients, entropy-coded by the port's encoder."""
    zz = np.array(blocks, np.int64)
    zz[:, 0] = np.diff(zz[:, 0], prepend=0)
    seg = jpeg._segment
    huff = [bytes([tc << 4]) + b"".join(jpeg._STD_HUFFMAN[(tc, 0)]) for tc in (0, 1)]
    return b"".join([
        b"\xff\xd8", seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"),
        seg(0xDB, b"\x00" + np.asarray(quant, np.uint8)[jpeg._ZIGZAG].tobytes()),
        seg(0xC0, bytes([8, 0, 8]) + (8 * len(zz)).to_bytes(2, "big") + bytes([1, 1, 0x11, 0])),
        seg(0xC4, b"".join(huff)), seg(0xDA, bytes([1, 1, 0x00, 0, 63, 0])),
        jpeg._huffman_stream(zz, np.zeros(len(zz), np.int64)), b"\xff\xd9"])


def test_out_of_range_samples_saturate_like_pil_and_cv2():
    """IDCT outputs outside 0..255 saturate, as the SIMD IDCT of PIL and cv2
    does (the C code's range-limit table would wrap the first block's
    lower rows to 0); high-contrast edges at quality 100 overshoot too."""
    blocks = np.zeros((8, 64), np.int64)
    blocks[:, 0] = [300, 1200, 1000, 700, -700, -1000, -1200, 0]
    blocks[0, 1:3] = [400, -400]
    got = _assert_decodes_like_pil_and_cv2(_grey_file(blocks, np.full(64, 4)))
    assert (got[:, 8:24] == 255).all() and (got[:, 32:56] == 0).all()
    y, x = np.mgrid[0:32, 0:48]
    board = (((x // 3 + y // 3) % 2) * 255).astype(np.uint8)
    for quality in (100, 30):
        _assert_decodes_like_pil_and_cv2(_pil(np.stack([board, 255 - board, board], -1),
                                              quality=quality))


_PROGRESSIVE_SIZES = [(1, 1), (7, 13), (17, 33), (64, 96)]


def _progressive(kind, img):
    if kind.startswith("pil"):
        sub = 0 if "444" in kind else 2
        src = img[:, :, 0] if kind == "pil-grey" else img
        return _pil(src, quality=85, progressive=True, optimize="optimize" in kind,
                    subsampling=sub, **({"restart_marker_blocks": 3} if "rst" in kind else {}))
    params = [cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_QUALITY, 90]
    if kind != "cv2":
        params += {"cv2-444": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                               cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444],
                   "cv2-422": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                               cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422],
                   "cv2-rst": [cv2.IMWRITE_JPEG_RST_INTERVAL, 2]}[kind]
    return _cv2(img, *params)


@pytest.mark.parametrize("hw", _PROGRESSIVE_SIZES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("kind", ["pil-420", "pil-420-optimize", "pil-444", "pil-444-optimize",
                                  "pil-grey", "pil-420-rst", "cv2", "cv2-444", "cv2-422",
                                  "cv2-rst"])
def test_progressive_files_decode_like_pil_and_cv2(kind, hw):
    """SOF2: DC first and refine scans, AC first scans with end-of-band
    runs, AC refine scans, non-interleaved bands at a component's edge and
    restart intervals, into the baseline path's coefficients and IDCT."""
    data = _progressive(kind, _photo(*hw, seed=sum(hw)))
    assert b"\xff\xc2" in data
    _assert_decodes_like_pil_and_cv2(data)


def test_progressive_full_size_frame_decodes_like_pil_and_cv2():
    """A ScanNet-size colour frame (968x1296, quality 90)."""
    _assert_decodes_like_pil_and_cv2(_pil(_photo(968, 1296, seed=5), quality=90,
                                          progressive=True))


@pytest.mark.parametrize("cut", [0.3, 0.6, 0.95])
def test_truncated_progressive_files_raise(cut):
    data = _pil(_photo(64, 96, seed=6), quality=90, progressive=True)
    with pytest.raises(ValueError, match="truncated"):
        jpeg.decode_jpeg(data[:int(len(data) * cut)], name="cut.jpg")
