"""The port's host I/O against cv2, PIL and the JAX package's ``io``.

The PNG reader (``io/png.py``) is held against cv2 and PIL on files they
wrote and on files with every row of each of the five filters (made with
the writer's ``filters`` option and checked by cv2 and PIL), at 8- and
16-bit grey and 8-bit RGB; the writer's files are read back by cv2, PIL and
the JAX loader. ``resize_nearest`` is held against cv2's ``INTER_NEAREST``
at the loaders' sizes; the PLY module against ``maskclustering_tpu.io.ply``;
the feed codec against ``maskclustering_tpu.io.feed`` on both branches.
Everything is compared for exact equality.
"""

import io
import struct
import zlib

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import maskclustering_tpu.io.feed as jax_feed
from maskclustering_tpu.io import image as jax_image
from maskclustering_tpu.io import ply as jax_ply
from maskclustering_tpu_torch.io import feed, image, ply, png

# one intra-op thread: the suite runs in parallel worker processes
torch.set_num_threads(1)

FORMATS = {"grey8": (np.uint8, None), "grey16": (np.uint16, None), "rgb8": (np.uint8, 3)}


def _image(fmt, h, w, seed, smooth=False):
    dtype, ch = FORMATS[fmt]
    rng = np.random.default_rng(seed)
    shape = (h, w) if ch is None else (h, w, ch)
    top = np.iinfo(dtype).max
    if not smooth:
        return rng.integers(0, top, size=shape, endpoint=True).astype(dtype)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (1000 + 7 * xx + 3 * yy) if dtype == np.uint16 else (xx + 2 * yy)
    if ch is not None:
        base = base[..., None] + np.arange(ch) * 17
    return ((base + rng.integers(0, 3, size=shape)) % (top + 1)).astype(dtype)


def _cv2_decode(data):
    out = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    return out[:, :, ::-1] if out.ndim == 3 else out  # cv2 holds colour as BGR


def _pil_decode(data):
    return np.asarray(Image.open(io.BytesIO(data)))


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("smooth", [False, True], ids=["noise", "smooth"])
def test_png_reader_matches_cv2_and_pil_files(fmt, smooth, tmp_path):
    """Files cv2 and PIL wrote (libpng and zlib choose filters per row)."""
    img = _image(fmt, 37, 53, seed=1, smooth=smooth)
    ok, buf = cv2.imencode(".png", img[:, :, ::-1] if img.ndim == 3 else img)
    assert ok
    bio = io.BytesIO()
    Image.fromarray(img).save(bio, format="PNG")
    for data in (buf.tobytes(), bio.getvalue()):
        got = png.decode_png(data)
        assert got.dtype == img.dtype
        np.testing.assert_array_equal(got, img)
        np.testing.assert_array_equal(got, _cv2_decode(data))
        np.testing.assert_array_equal(got, _pil_decode(data))


def _row_filters(data):
    idat = b"".join(p for k, p in png._chunks(data) if k == b"IDAT")
    hdr = png._parse_header(next(p for k, p in png._chunks(data) if k == b"IHDR"))
    return set(np.frombuffer(zlib.decompress(idat), np.uint8).reshape(hdr.height, -1)[:, 0]
               .tolist())


def test_png_reader_full_size_depth_frames():
    """A 480x640 16-bit depth frame (a curved surface, 2 mm noise) as cv2
    and PIL write it: cv2 filters every row with Sub, PIL chooses per row
    and puts Paeth rows in it."""
    rng = np.random.default_rng(2)
    yy, xx = np.mgrid[0:480, 0:640]
    img = (1500 + 0.004 * (xx - 300) ** 2 + 0.003 * (yy - 200) ** 2
           + rng.normal(0, 2, (480, 640))).astype(np.uint16)
    ok, buf = cv2.imencode(".png", img)
    bio = io.BytesIO()
    Image.fromarray(img).save(bio, format="PNG")
    assert ok and 4 in _row_filters(bio.getvalue())
    for data in (buf.tobytes(), bio.getvalue()):
        np.testing.assert_array_equal(png.decode_png(data), img)


@pytest.mark.parametrize("content", ["id_map", "noise"])
@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_png_reader_paeth_rows_resolved_and_by_wavefront(content, fmt):
    """PIL's adaptive filter on an id-map of boxes puts Paeth rows with few
    bytes to resolve (decoded a row at a time); noise with every row Paeth
    holds so many that the reader takes the wavefront. Both give the
    pixels back, and the wavefront alone gives them too."""
    dtype, ch = FORMATS[fmt]
    h, w = 60, 80
    if content == "id_map":
        img = np.zeros((h, w), np.int64)
        rng = np.random.default_rng(5)
        for k in range(1, 13):
            y, x = rng.integers(0, h - 8), rng.integers(0, w - 8)
            img[y:y + rng.integers(4, 30), x:x + rng.integers(4, 30)] = k * 19
        if ch:
            img = np.stack([img + 5 * c for c in range(ch)], -1)
        img = img.astype(dtype)
        bio = io.BytesIO()
        Image.fromarray(img).save(bio, format="PNG")
        data = bio.getvalue()
    else:
        img = _image(fmt, h, w, seed=6)
        data = png.encode_png(img, filters=4)
    assert 4 in _row_filters(data)
    np.testing.assert_array_equal(png.decode_png(data), img)
    idat = b"".join(p for k, p in png._chunks(data) if k == b"IDAT")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    bpp = rows.shape[1] // w
    flat = img.astype(">u2") if dtype == np.uint16 else img
    want = np.ascontiguousarray(flat).view(np.uint8).reshape(h, -1)
    np.testing.assert_array_equal(png._unfilter_wavefront(rows[:, 0], rows[:, 1:], bpp), want)
    resolved = [png._paeth_row(np.zeros(w * bpp, np.uint8), want[r - 1], bpp, 1 << 30)[1]
                for r in range(1, h) if rows[r, 0] == 4]
    assert (sum(resolved) <= 16 * (h + w)) == (content == "id_map")


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("filt", ["none", "sub", "up", "average", "paeth", "mixed",
                                  "mixed_none_sub_up"])
def test_png_reader_each_filter_type(fmt, filt):
    """Files with every row of one filter type (or a seeded mix of all five,
    or of the three without a left-to-right recurrence), made by the
    writer's ``filters`` option: cv2 and PIL give back the image, which
    checks the files, and so does the reader."""
    img = _image(fmt, 23, 31, seed=3, smooth=filt.startswith("mixed"))
    names = ["none", "sub", "up", "average", "paeth"]
    kinds = {"mixed": 5, "mixed_none_sub_up": 3}
    ftypes = (np.random.default_rng(4).integers(0, kinds[filt], size=img.shape[0])
              if filt in kinds else names.index(filt))
    data = png.encode_png(img, filters=ftypes)
    assert _row_filters(data) == set(np.atleast_1d(ftypes).tolist())
    np.testing.assert_array_equal(png.decode_png(data), img)
    np.testing.assert_array_equal(_cv2_decode(data), img)
    np.testing.assert_array_equal(_pil_decode(data), img)


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_png_writer_round_trips_through_cv2_pil_and_jax(fmt, tmp_path):
    img = _image(fmt, 29, 41, seed=5)
    path = str(tmp_path / "x.png")
    png.write_png(path, img)
    data = open(path, "rb").read()
    np.testing.assert_array_equal(_cv2_decode(data), img)
    np.testing.assert_array_equal(_pil_decode(data), img)
    np.testing.assert_array_equal(png.read_png(path), img)
    assert png.png_size(path) == (41, 29)
    if fmt == "rgb8":
        np.testing.assert_array_equal(jax_image.read_rgb(path), img)
        np.testing.assert_array_equal(image.read_rgb(path), img)
    else:
        np.testing.assert_array_equal(jax_image.read_mask_png(path), img)


def test_depth_and_mask_writers_match_jax_readers(tmp_path):
    rng = np.random.default_rng(6)
    depth_m = rng.uniform(0.2, 6.0, size=(24, 32)).astype(np.float32)
    image.write_depth_png(str(tmp_path / "d.png"), depth_m * 1000.0)
    jax_image.write_depth_png(str(tmp_path / "dj.png"), depth_m * 1000.0)
    for scale in (1000.0, 4000.0):
        want = jax_image.read_depth_png(str(tmp_path / "dj.png"), scale)
        for name in ("d.png", "dj.png"):
            got = image.read_depth_png(str(tmp_path / name), scale)
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want)
    for top, dtype in ((200, np.uint8), (3000, np.uint16)):
        ids = rng.integers(0, top, size=(24, 32))
        image.write_mask_png(str(tmp_path / "m.png"), ids)
        got = jax_image.read_mask_png(str(tmp_path / "m.png"))
        assert got.dtype == dtype and image.read_mask_png(str(tmp_path / "m.png")).dtype == dtype
        np.testing.assert_array_equal(got, ids)


def test_png_refusals(tmp_path):
    img = _image("grey8", 8, 8, seed=7)
    data = bytearray(png.encode_png(img))
    data[-20] ^= 1  # inside the IDAT payload: its CRC no longer holds
    with pytest.raises(ValueError, match="CRC"):
        png.decode_png(bytes(data))
    pal = io.BytesIO()
    Image.fromarray(img).convert("P").save(pal, format="PNG")
    with pytest.raises(ValueError, match="unsupported"):
        png.decode_png(pal.getvalue())
    with pytest.raises(ValueError, match="signature"):
        png.decode_png(b"GIF89a" + bytes(40))
    # a JPEG colour frame is no refusal: it decodes to the JAX reader's pixels
    jpg = tmp_path / "c.jpg"
    Image.fromarray(_image("rgb8", 8, 8, seed=8)).save(jpg)
    np.testing.assert_array_equal(image.read_rgb(str(jpg)), jax_image.read_rgb(str(jpg)))


@pytest.mark.parametrize("src_wh,dst_wh", [
    ((1296, 968), (640, 480)), ((640, 480), (640, 480)), ((1920, 1440), (640, 480)),
    ((1280, 1024), (640, 480)), ((640, 480), (1296, 968)), ((1024, 1024), (640, 480)),
    ((77, 53), (31, 29)), ((31, 29), (77, 53)), ((1000, 700), (640, 480)),
    ((1296, 968), (320, 240))])
def test_resize_nearest_matches_cv2(src_wh, dst_wh):
    rng = np.random.default_rng(9)
    for dtype in (np.uint8, np.uint16):
        img = rng.integers(0, 250, size=src_wh[::-1]).astype(dtype)
        got = image.resize_nearest(img, dst_wh)
        np.testing.assert_array_equal(got, cv2.resize(img, dst_wh,
                                                      interpolation=cv2.INTER_NEAREST))
        np.testing.assert_array_equal(got, jax_image.resize_nearest(img, dst_wh))


def test_resize_nearest_index_rule_is_cv2s_at_every_small_size():
    """Every (src, dst) pair up to 64 on an axis: the reciprocal of the
    scale, not src / dst, decides the source index."""
    for src in range(1, 65):
        img = np.arange(src, dtype=np.uint16)[None, :]
        for dst in range(1, 65):
            want = cv2.resize(img, (dst, 1), interpolation=cv2.INTER_NEAREST)
            np.testing.assert_array_equal(image.resize_nearest(img, (dst, 1)), want,
                                          err_msg=f"{src} -> {dst}")


@pytest.mark.parametrize("colors", [False, True])
def test_ply_points_round_trip_with_jax(colors, tmp_path):
    rng = np.random.default_rng(10)
    pts = rng.normal(size=(57, 3)).astype(np.float32)
    cols = rng.integers(0, 256, size=(57, 3)).astype(np.uint8) if colors else None
    ply.write_ply_points(str(tmp_path / "p.ply"), pts, cols)
    jax_ply.write_ply_points(str(tmp_path / "j.ply"), pts, cols)
    assert open(tmp_path / "p.ply", "rb").read() == open(tmp_path / "j.ply", "rb").read()
    for name in ("p.ply", "j.ply"):
        got = ply.read_ply_points(str(tmp_path / name), return_colors=colors)
        want = jax_ply.read_ply_points(str(tmp_path / name), return_colors=colors)
        for g, w in zip(got if colors else (got,), want if colors else (want,)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("fmt", ["binary_little_endian", "binary_big_endian", "ascii"])
def test_ply_mesh_matches_jax(fmt, tmp_path):
    rng = np.random.default_rng(11)
    verts = rng.normal(size=(9, 3)).astype(np.float32)
    faces = rng.integers(0, 9, size=(6, 3))
    cat = rng.integers(0, 40, size=6)
    end = ">" if fmt == "binary_big_endian" else "<"
    head = (f"ply\nformat {fmt} 1.0\nelement vertex 9\nproperty float x\nproperty float y\n"
            f"property float z\nelement face 6\nproperty list uchar int vertex_indices\n"
            f"property int category_id\nend_header\n").encode()
    if fmt == "ascii":
        body = "".join(" ".join(map(repr, v.tolist())) + "\n" for v in verts)
        body += "".join(f"3 {a} {b} {c} {k}\n" for (a, b, c), k in zip(faces, cat))
        data = head + body.encode()
    else:
        body = verts.astype(end + "f4").tobytes()
        for tri, k in zip(faces, cat):
            body += bytes([3]) + tri.astype(end + "i4").tobytes() + np.asarray(
                [k], end + "i4").tobytes()
        data = head + body
    path = tmp_path / "m.ply"
    path.write_bytes(data)
    got, want = ply.read_ply_mesh(str(path)), jax_ply.read_ply_mesh(str(path))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g, w)
    assert sorted(got[2]) == sorted(want[2]) == ["category_id"]
    np.testing.assert_array_equal(got[2]["category_id"], want[2]["category_id"])
    np.testing.assert_array_equal(ply.read_ply_points(str(path)),
                                  jax_ply.read_ply_points(str(path)))


def _depth_cases():
    rng = np.random.default_rng(12)
    mm = rng.integers(0, 8000, size=(3, 16, 20)).astype(np.float32) * np.float32(1 / 1000.0)
    quarter = rng.integers(0, 60000, size=(3, 16, 20)).astype(np.float32) * np.float32(
        1 / 4000.0)
    noisy = mm + rng.normal(scale=1e-4, size=mm.shape).astype(np.float32)
    far = mm.copy()
    far[0, 0, 0] = 70.0
    nonfinite = mm.copy()
    nonfinite[1, 2, 3] = np.nan
    return {"mm": (mm, 1000.0), "quarter_mm": (quarter, 4000.0), "noisy": (noisy, 0.0),
            "out_of_range": (far, 0.0), "nonfinite": (nonfinite, 0.0),
            "float64": (mm.astype(np.float64), 0.0)}


@pytest.mark.parametrize("case", sorted(_depth_cases()))
def test_feed_depth_codec_matches_jax(case):
    depths, scale = _depth_cases()[case]
    enc, got_scale = feed.encode_depth(depths)
    want, want_scale = jax_feed.encode_depth(depths)
    assert got_scale == want_scale == scale
    assert enc.dtype == want.dtype == (np.uint16 if scale else np.float32)
    np.testing.assert_array_equal(enc, want)
    dec = feed.decode_depth(torch.from_numpy(np.ascontiguousarray(enc)), got_scale)
    jax_dec = np.asarray(jax_feed.decode_depth(jnp.asarray(want), want_scale))
    assert dec.dtype == torch.float32
    np.testing.assert_array_equal(dec.numpy(), jax_dec)
    np.testing.assert_array_equal(dec.numpy(), np.asarray(depths, np.float32))


@pytest.mark.parametrize("lo,hi", [(0, 255), (0, 65535), (-1, 5), (0, 70000)])
def test_feed_seg_codec_matches_jax(lo, hi):
    segs = np.random.default_rng(13).integers(lo, hi, size=(2, 8, 9), endpoint=True)
    segs = segs.astype(np.int32)
    enc, want = feed.encode_seg(segs), jax_feed.encode_seg(segs)
    assert enc.dtype == want.dtype
    np.testing.assert_array_equal(enc, want)
    depths = np.zeros(segs.shape, np.float32)
    d_dev, s_dev = feed.to_device_frames(depths, segs, "cpu")
    assert s_dev.dtype == torch.int32 and d_dev.dtype == torch.float32
    np.testing.assert_array_equal(s_dev.numpy(), segs)


@pytest.mark.parametrize("case", ["mm", "noisy"])
def test_feed_frames_equal_the_host_arrays(case):
    depths, _ = _depth_cases()[case]
    segs = np.random.default_rng(14).integers(0, 40, size=depths.shape).astype(np.int32)
    d_dev, s_dev = feed.to_device_frames(depths, segs, "cpu")
    np.testing.assert_array_equal(d_dev.numpy(), depths)
    np.testing.assert_array_equal(s_dev.numpy(), segs)


# ---------------------------------------------------------------------------
# read_rgb: cv2's EXIF orientation (C8) and PNG kinds (C9), held against the
# JAX read_rgb (cv2.imread) on the same files
# ---------------------------------------------------------------------------

_PHOTO = np.random.default_rng(48).integers(0, 256, (48, 64, 3), dtype=np.uint8)
_TIFF_TYPES = {"short": 3, "long": 4, "ascii": 2, "rational": 5}


def _tiff(entries, order="II", ifd1=(), tail=b""):
    """A TIFF block by hand: IFD0's ``entries`` (tag, type name, count,
    value: an int or four raw bytes), then IFD1's, then ``tail``."""
    e = "<" if order == "II" else ">"

    def ifd(ents, next_at):
        out = struct.pack(e + "H", len(ents))
        for tag, typ, count, value in ents:
            head = struct.pack(e + "HHI", tag, _TIFF_TYPES[typ], count)
            if isinstance(value, bytes):
                out += head + value
            elif typ == "short":
                out += head + struct.pack(e + "HH", value, 0)
            else:
                out += head + struct.pack(e + "I", value)
        return out + struct.pack(e + "I", next_at)

    first = ifd(entries, 0)
    if ifd1:
        first = ifd(entries, 8 + len(first))
    return order.encode() + struct.pack(e + "HI", 42, 8) + first + (
        ifd(ifd1, 0) if ifd1 else b"") + tail


def _orient(value, order="II"):
    return _tiff([(0x0112, "short", 1, value)], order)


def _jpeg_with(*app1s):
    """PIL's JPEG of the photo with these APP1 payloads after SOI."""
    buf = io.BytesIO()
    Image.fromarray(_PHOTO).save(buf, format="JPEG", quality=95)
    data = buf.getvalue()
    return data[:2] + b"".join(b"\xff\xe1" + struct.pack(">H", len(p) + 2) + p
                               for p in app1s) + data[2:]


def _chunk(kind, payload, crc=None):
    crc = zlib.crc32(kind + payload) & 0xFFFFFFFF if crc is None else crc
    return struct.pack(">I", len(payload)) + kind + payload + struct.pack(">I", crc)


def _png_with(*exifs, after=(), bad_crc=False):
    """PIL's PNG of the photo with these ``eXIf`` payloads before IDAT (and
    ``after`` it)."""
    buf = io.BytesIO()
    Image.fromarray(_PHOTO).save(buf, format="PNG")
    data = buf.getvalue()
    i, k = data.index(b"IDAT") - 4, data.index(b"IEND") - 4
    before = b"".join(_chunk(b"eXIf", p, 0 if bad_crc else None) for p in exifs)
    return data[:i] + before + data[i:k] + b"".join(_chunk(b"eXIf", p) for p in after) + data[k:]


def _pil_oriented(fmt, value):
    """PIL's own file of the photo with orientation ``value`` (its Exif
    writer: little-endian, the tag in IFD0)."""
    ex = Image.Exif()
    ex[0x0112] = value
    buf = io.BytesIO()
    Image.fromarray(_PHOTO).save(buf, format=fmt, exif=ex.tobytes(), **(
        {"quality": 95} if fmt == "JPEG" else {}))
    return buf.getvalue()


def _assert_read_rgb_like_jax(tmp_path, data, ext):
    path = str(tmp_path / f"frame.{ext}")
    with open(path, "wb") as f:
        f.write(data)
    want = jax_image.read_rgb(path)
    got = image.read_rgb(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("value", range(1, 9))
@pytest.mark.parametrize("source", ["pil", "II", "MM"])
@pytest.mark.parametrize("fmt", ["jpeg", "png"])
def test_read_rgb_turns_by_the_exif_orientation_like_cv2(fmt, source, value, tmp_path):
    """C8: each of the eight orientations, in PIL's own file and in a
    hand-built block of either byte order, turns the frame as cv2 does."""
    if source == "pil":
        data = _pil_oriented(fmt.upper(), value)
    elif fmt == "jpeg":
        data = _jpeg_with(b"Exif\x00\x00" + _orient(value, source))
    else:
        data = _png_with(_orient(value, source))
    got = _assert_read_rgb_like_jax(tmp_path, data, "jpg" if fmt == "jpeg" else "png")
    assert got.shape == ((64, 48, 3) if value >= 5 else (48, 64, 3))
    # the .sens route (decode_rgb) stays unturned, as PIL decodes
    assert image.decode_rgb(data).shape == (48, 64, 3)


_EXIF_FAULTS = {
    # value out of range, or not a SHORT: cv2 reads 16 bits at byte 8
    "zero": lambda o: [_orient(0, o)],
    "nine": lambda o: [_orient(9, o)],
    "65535": lambda o: [_orient(65535, o)],
    "long": lambda o: [_tiff([(0x0112, "long", 1, 6)], o)],
    "count-2": lambda o: [_tiff([(0x0112, "short", 2, 6)], o)],
    # the tag only in IFD1, or twice in IFD0 (the first wins)
    "ifd1-only": lambda o: [_tiff([(0x011A, "rational", 1, 8)], o, ifd1=[(0x0112, "short", 1, 6)])],
    "duplicate": lambda o: [_tiff([(0x0112, "short", 1, 6), (0x0112, "short", 1, 3)], o)],
    # malformed: a count past the data, a value read out of bounds before
    # the tag (a string, a rational), an unknown tag before it, the block
    # cut inside the value or just after it, IFD0 out of bounds, a bad mark
    "count-past-data": lambda o: [_orient(6, o)[:8] + (b"\x00\x05" if o == "MM" else b"\x05\x00")
                                  + _orient(6, o)[10:22]],
    "bad-make-first": lambda o: [_tiff([(0x010F, "ascii", 20, 5000), (0x0112, "short", 1, 6)], o)],
    "bad-xres-first": lambda o: [_tiff([(0x011A, "rational", 1, 5000),
                                        (0x0112, "short", 1, 6)], o)],
    "short-make-first": lambda o: [_tiff([(0x010F, "ascii", 3, b"ab\x00\x00"),
                                          (0x0112, "short", 1, 7)], o)],
    "unknown-first": lambda o: [_tiff([(0x9999, "rational", 1, 5000), (0x0112, "short", 1, 6)], o)],
    "cut-inside-value": lambda o: [_orient(6, o)[:19]],
    "cut-after-value": lambda o: [_orient(6, o)[:20]],
    "ifd0-out-of-bounds": lambda o: [_orient(6, o)[:4] + b"\xff\xff\x00\x00" + _orient(6, o)[8:]],
    "bad-mark": lambda o: [_orient(6, o).replace(b"*", b"+", 1)],
    # several blocks: a JPEG's Exif segments feed one map (the first value
    # wins); a PNG keeps its first valid eXIf chunk
    "two-blocks": lambda o: [_orient(6, o), _orient(3, o)],
    "bad-then-good": lambda o: [_orient(6, o).replace(b"*", b"+", 1), _orient(8, o)],
    "no-tag-then-good": lambda o: [_tiff([(0x011A, "rational", 1, 8)], o), _orient(5, o)],
}


@pytest.mark.parametrize("order", ["II", "MM"])
@pytest.mark.parametrize("case", sorted(_EXIF_FAULTS))
@pytest.mark.parametrize("fmt", ["jpeg", "png"])
def test_read_rgb_reads_malformed_exif_like_cv2(fmt, case, order, tmp_path):
    """C8: a missing, malformed, out-of-range or repeated tag, and one
    only IFD1 holds, give cv2's frame."""
    blocks = _EXIF_FAULTS[case](order)
    if fmt == "jpeg":
        data = _jpeg_with(*[b"Exif\x00\x00" + b for b in blocks])
    else:
        data = _png_with(*blocks)
    _assert_read_rgb_like_jax(tmp_path, data, "jpg" if fmt == "jpeg" else "png")


@pytest.mark.parametrize("case", [
    "xmp-first", "exif-header-wrong", "app1-empty-first", "png-after-idat",
    "png-before-and-after", "png-bad-crc", "png-bad-byte-order-then-good"])
def test_read_rgb_finds_the_exif_block_cv2_reads(case, tmp_path):
    """C8: which APP1 segment or eXIf chunk cv2 takes the tag from."""
    six = _orient(6)
    data, ext = {
        "xmp-first": (lambda: _jpeg_with(b"http://ns.adobe.com/xap/1.0/\x00<x/>",
                                         b"Exif\x00\x00" + six), "jpg"),
        "exif-header-wrong": (lambda: _jpeg_with(b"Exif\x00\x01" + six), "jpg"),
        "app1-empty-first": (lambda: _jpeg_with(b"", b"Exif\x00\x00" + six), "jpg"),
        "png-after-idat": (lambda: _png_with(after=[six]), "png"),
        "png-before-and-after": (lambda: _png_with(six, after=[_orient(3)]), "png"),
        "png-bad-crc": (lambda: _png_with(six, bad_crc=True), "png"),
        "png-bad-byte-order-then-good": (lambda: _png_with(b"IM" + _orient(8, "MM")[2:], six),
                                         "png"),
    }[case]
    _assert_read_rgb_like_jax(tmp_path, data(), ext)


_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _png_by_hand(samples, depth, ctype, interlace=0, plte=None, trns=None):
    """A PNG assembled with ``struct`` and ``zlib``: (H, W, C) samples at
    ``depth`` bits, Paeth rows, Adam7 when ``interlace``."""
    def rows(s):
        h, w, c = s.shape
        if depth < 8:
            per = 8 // depth
            v = np.concatenate([s[:, :, 0], np.zeros((h, (-w) % per), np.uint8)], axis=1)
            shifts = (8 - depth * (1 + np.arange(per))).astype(np.uint8)
            raw = (v.reshape(h, -1, per).astype(np.uint8) << shifts).sum(axis=2).astype(np.uint8)
            bpp = 1
        elif depth == 16:
            raw, bpp = s.astype(">u2").view(np.uint8).reshape(h, -1), 2 * c
        else:
            raw, bpp = s.astype(np.uint8).reshape(h, -1), c
        return png._filter_rows(raw, bpp, 4).tobytes()

    h, w = samples.shape[:2]
    passes = [samples[y0::dy, x0::dx] for x0, y0, dx, dy in _ADAM7] if interlace else [samples]
    stream = b"".join(rows(p) for p in passes if p.size)
    out = png.SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                                      interlace))
    out += (_chunk(b"PLTE", plte) if plte is not None else b"") + (
        _chunk(b"tRNS", trns) if trns is not None else b"")
    return out + _chunk(b"IDAT", zlib.compress(stream)) + _chunk(b"IEND", b"")


def _pil_png(img, mode, **kw):
    buf = io.BytesIO()
    im = Image.fromarray(img)
    (im.convert(mode) if mode else im).save(buf, format="PNG", **kw)
    return buf.getvalue()


def _cv2_png(img):
    ok, buf = cv2.imencode(".png", img)
    assert ok
    return buf.tobytes()


def _png_kind(kind, h, w):
    rng = np.random.default_rng(sum(map(ord, kind)) + h * w)
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    wide = rng.integers(0, 65536, (h, w, 4), dtype=np.uint16)
    interlace = int(kind.endswith("-adam7"))
    base = kind.removesuffix("-adam7")
    if base in ("grey1", "grey2", "grey4"):
        depth = int(base[-1])
        return _png_by_hand(rng.integers(0, 1 << depth, (h, w, 1), dtype=np.uint8), depth, 0,
                            interlace)
    if base in ("palette1", "palette4", "palette8", "palette8-trns"):
        depth = int(base[7])
        n = int(rng.integers(2, 1 << depth, endpoint=True))
        idx = rng.integers(0, n, (h, w, 1), dtype=np.uint8)
        plte = rng.integers(0, 256, 3 * n, dtype=np.uint8).tobytes()
        trns = bytes(range(0, 255, 9))[:n] if base.endswith("trns") else None
        return _png_by_hand(idx, depth, 3, interlace, plte, trns)
    if interlace:
        depth = 16 if "16" in base else 8
        ctype, c = {"grey": (0, 1), "rgb": (2, 3), "grey-alpha": (4, 2), "rgba": (6, 4)}[
            base.removesuffix("16").removesuffix("8")]
        samples = wide[:, :, :c] if depth == 16 else rgb.repeat(2, axis=2)[:, :, :c]
        return _png_by_hand(samples, depth, ctype, interlace)
    return {
        "palette-pil": lambda: _pil_png(rgb, "P"),
        "palette-pil-trns": lambda: _pil_png(rgb, "P", transparency=3),
        "bilevel-pil": lambda: _pil_png(rgb, "1"),
        "grey-alpha-pil": lambda: _pil_png(rgb, "LA"),
        "rgba-pil": lambda: _pil_png(rgb, "RGBA"),
        "grey16": lambda: _cv2_png(wide[:, :, 0]),
        "rgb16": lambda: _cv2_png(wide[:, :, :3]),
        "rgba16": lambda: _cv2_png(wide),
    }[base]()


_PNG_KINDS = ["palette-pil", "palette-pil-trns", "bilevel-pil", "grey-alpha-pil", "rgba-pil",
              "grey16", "rgb16", "rgba16", "grey1", "grey2", "grey4", "palette1", "palette4",
              "palette8", "palette8-trns", "grey8-adam7", "grey16-adam7", "rgb8-adam7",
              "rgb16-adam7", "grey-alpha8-adam7", "rgba16-adam7", "grey1-adam7",
              "palette4-adam7", "palette8-trns-adam7"]


@pytest.mark.parametrize("hw", [(13, 17), (1, 1), (3, 9)], ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("kind", _PNG_KINDS)
def test_read_rgb_reads_every_png_kind_like_cv2(kind, hw, tmp_path):
    """C9: palette (with and without ``tRNS``), grey at 1, 2 and 4 bits,
    16-bit grey, RGB and RGBA (the high byte), grey+alpha and Adam7 files
    read as cv2 reads them; before C9 these raised."""
    _assert_read_rgb_like_jax(tmp_path, _png_kind(kind, *hw), "png")


def test_pil_route_keeps_pils_16_bit_grey_and_reads_adam7():
    """``decode_png_rgb`` (the PIL call sites) clips 16-bit grey where
    cv2 keeps the high byte; both read Adam7 files as their library does."""
    for kind in ("grey16", "grey16-adam7", "rgb16-adam7", "palette4-adam7", "grey1-adam7"):
        data = _png_kind(kind, 13, 17)
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        np.testing.assert_array_equal(png.decode_png_rgb(data), want)
    data = _png_kind("grey16", 13, 17)
    wide = png.decode_png(data)
    np.testing.assert_array_equal(png.decode_png_rgb(data)[:, :, 0], np.minimum(wide, 255))
    np.testing.assert_array_equal(png.decode_png_cv2(data).samples[:, :, 0], wide >> 8)
