"""``frames_to_gif`` (``visualize/mask2d.py``, ``io/gif.py``) against the
JAX function, which runs Pillow 12.1.0's quantizer, dither and GIF writer.

Every case writes its frames to files, runs both functions on the same
paths and asserts the two GIF files are equal byte for byte: the
``vis_mask_frame`` outputs of ``tests/test_visualize.py``'s fake dataset
(two frames, and a sequence whose mask moves), frames of more than 256
colours, one frame (interlaced, and under 16 pixels where it is not), two
identical consecutive frames (merged, their durations summed), frames
under 16 pixels on a side, RGBA, grey, palette and JPEG inputs, a
palette too large to trim (512 x 512 pixels), frames of different sizes
and every fps of 1, 5, 10 and 30. The pieces are held to Pillow on their
own too: the median cut and the Floyd-Steinberg mapping on random images.
"""

import io

import numpy as np
import pytest
import torch
from PIL import Image

from maskclustering_tpu.visualize import mask2d as jax_mask2d
from maskclustering_tpu_torch.io import gif
from maskclustering_tpu_torch.visualize import mask2d

# one intra-op thread: the suite runs in parallel worker processes
torch.set_num_threads(1)


class FakeDS:
    """``tests/test_visualize.py``'s dataset: one mask on a grey frame,
    moved ``shift`` pixels a frame."""

    def __init__(self, shift=0):
        self.shift = shift

    def get_segmentation(self, fid, align_with_depth=True):
        seg = np.zeros((40, 60), dtype=np.uint8)
        s = self.shift * fid
        seg[5:25, 5 + s:30 + s] = 1
        return seg

    def get_rgb(self, fid):
        return np.full((40, 60, 3), 128, dtype=np.uint8)


def _write(tmp_path, frames, fmt="PNG", mode=None):
    paths = []
    for i, frame in enumerate(frames):
        path = tmp_path / f"{i}.{'jpg' if fmt == 'JPEG' else 'png'}"
        im = Image.fromarray(frame)
        (im.convert(mode) if mode else im).save(path, format=fmt)
        paths.append(str(path))
    return paths


def _assert_gifs_equal(tmp_path, paths, fps=10):
    want = jax_mask2d.frames_to_gif(paths, str(tmp_path / "jax" / "a.gif"), fps=fps)
    got = mask2d.frames_to_gif(paths, str(tmp_path / "port" / "a.gif"), fps=fps)
    with open(want, "rb") as a, open(got, "rb") as b:
        want_bytes, got_bytes = a.read(), b.read()
    assert got_bytes[:6] == b"GIF89a" and got_bytes[-1:] == b";"
    assert got_bytes == want_bytes
    return got_bytes


def _noise(seed, n, h, w):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(n)]


def _moving(n, h, w, seed=0):
    """A textured background and a block that moves: small delta frames."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255 // w, y * 255 // h, (x + y) % 64 * 4], -1).astype(np.uint8)
    base = np.clip(base + rng.integers(-6, 7, base.shape), 0, 255).astype(np.uint8)
    frames = []
    for k in range(n):
        f = base.copy()
        f[2 + k:9 + k, 3 + 2 * k:12 + 2 * k] = [250, 20, 40]
        frames.append(f)
    return frames


@pytest.mark.parametrize("shift", [0, 4])
def test_vis_mask_frame_sequences(shift, tmp_path):
    ds = FakeDS(shift)
    paths = [jax_mask2d.vis_mask_frame(ds, fid, str(tmp_path / "vis")) for fid in range(3)]
    _assert_gifs_equal(tmp_path, paths, fps=5)
    # the port's own vis files (seven-segment labels) go through as well
    ours = [mask2d.vis_mask_frame(ds, fid, str(tmp_path / "vis_port")) for fid in range(3)]
    _assert_gifs_equal(tmp_path / "ours", ours, fps=5)


@pytest.mark.parametrize("fps", [1, 5, 10, 30])
def test_every_fps(fps, tmp_path):
    _assert_gifs_equal(tmp_path, _write(tmp_path, _moving(4, 30, 44)), fps=fps)


@pytest.mark.parametrize("case", [
    "over-256-colours", "one-frame", "one-frame-under-16", "identical-pair",
    "identical-then-change", "under-16", "rgba", "grey", "palette", "jpeg",
    "no-trim-512", "sizes-differ", "two-colours"])
def test_cases(case, tmp_path):
    frames, kw = {
        "over-256-colours": lambda: (_noise(1, 3, 40, 50), {}),
        "one-frame": lambda: (_noise(2, 1, 37, 53), {}),
        "one-frame-under-16": lambda: (_noise(3, 1, 10, 40), {}),
        "identical-pair": lambda: (_noise(4, 1, 24, 30) * 2, {}),
        "identical-then-change": lambda: ([_moving(2, 26, 34)[0]] * 2 + _moving(2, 26, 34)[1:], {}),
        "under-16": lambda: (_moving(3, 12, 15), {}),
        "rgba": lambda: ([np.dstack([f, np.random.default_rng(k).integers(0, 256, f.shape[:2],
                                                                            dtype=np.uint8)])
                          for k, f in enumerate(_moving(3, 20, 28))], {}),
        "grey": lambda: (_moving(3, 20, 28), {"mode": "L"}),
        "palette": lambda: (_moving(3, 20, 28), {"mode": "P"}),
        "jpeg": lambda: (_moving(3, 24, 32), {"fmt": "JPEG"}),
        "no-trim-512": lambda: ([f for f in _moving(2, 512, 512)], {}),
        "sizes-differ": lambda: ([_noise(5, 1, 20, 30)[0], _noise(6, 1, 25, 28)[0],
                                  _noise(7, 1, 12, 40)[0]], {}),
        "two-colours": lambda: ([np.zeros((20, 20, 3), np.uint8),
                                 np.full((20, 20, 3), 255, np.uint8)], {}),
    }[case]()
    _assert_gifs_equal(tmp_path, _write(tmp_path, frames, **kw))


def test_no_frames_raise(tmp_path):
    with pytest.raises(ValueError, match="no frames"):
        mask2d.frames_to_gif([], str(tmp_path / "a.gif"))


@pytest.mark.parametrize("seed", range(12))
def test_median_cut_and_dither_equal_pillow(seed):
    rng = np.random.default_rng(seed)
    h, w = (int(v) for v in rng.integers(1, 48, 2))
    if seed % 3 == 0:  # few colours of equal counts: ties in the box heap
        cols = rng.integers(0, 256, (int(rng.integers(2, 400)), 3), dtype=np.uint8)
        img = cols[np.arange(h * w) % len(cols)].reshape(h, w, 3)
    elif seed % 3 == 1:
        img = (rng.integers(0, 8, (h, w, 3)) * 32).astype(np.uint8)
    else:
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    q = Image.fromarray(img).quantize(colors=256)
    palette, index = gif.quantize(img)
    np.testing.assert_array_equal(palette, np.array(q.getpalette(), np.uint8).reshape(-1, 3))
    np.testing.assert_array_equal(index, np.asarray(q))
    other = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    np.testing.assert_array_equal(gif.dither(other, palette),
                                  np.asarray(Image.fromarray(other).quantize(palette=q)))


def test_median_cut_past_65536_colours():
    """More distinct colours than Quant.c's histogram holds: the colours
    are shifted right until they fit."""
    img = np.random.default_rng(9).integers(0, 256, (300, 300, 3), dtype=np.uint8)
    q = Image.fromarray(img).quantize(colors=256)
    palette, index = gif.quantize(img)
    np.testing.assert_array_equal(palette, np.array(q.getpalette(), np.uint8).reshape(-1, 3))
    np.testing.assert_array_equal(index, np.asarray(q))


def test_lzw_past_4096_codes():
    """A code stream long enough to fill the table: the clear code in
    place of code 4,096, read back by Pillow's decoder."""
    frame = np.random.default_rng(10).integers(0, 256, (90, 90, 3), dtype=np.uint8)
    data = gif.encode_gif([frame], duration=100)
    back = Image.open(io.BytesIO(data))
    palette, index = gif.quantize(frame)
    np.testing.assert_array_equal(np.asarray(back), index)
