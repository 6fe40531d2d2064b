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
