"""Animated GIF writer in numpy: the bytes of the JAX ``frames_to_gif``.

The JAX package (``visualize/mask2d.py:75-95``) quantises the first RGB
frame to 256 colours with Pillow, maps every later frame onto that
palette, and saves the frames with Pillow's GIF plugin. The card's
machine has no Pillow, so this module follows Pillow 12.1.0 step by step:

- **median cut** (``Quant.c``, ``quantize(colors=256)`` on RGB): the
  colour histogram, its colours right-shifted by the least scale that
  leaves at most 65,536 of them; boxes split while fewer than 256 exist,
  the box of most pixels first (``QuantHeap.c``'s binary heap and its
  ties), along the axis of largest range weighted 77, 150, 29 (red wins
  ties, then green), at the weighted median with every colour of the
  median's value on the upper side; single-colour boxes leave the heap.
  The palette is the rounded mean of each box's pixels, numbered by the
  box tree's leaves in order (the upper side first), and each colour is
  mapped to its nearest palette entry, its own box's entry winning ties,
  then the entry nearest that one, then the lowest index;
- **Floyd-Steinberg** onto the first frame's palette (``Convert.c``
  ``topalette``): the error diffused 7, 3, 5, 1 (/16, truncated toward
  zero) in row order, each colour matched through ``Palette.c``'s cache:
  the entry nearest the colour's 4-aligned corner, the lowest index on
  ties;
- **the writer** (``GifImagePlugin.py``): with ``optimize`` on, a
  palette of fewer than 512 x 512 pixels loses its unused entries when
  it has holes or would halve; frames after the first are cropped to the
  box that changed and hold a new transparency index where a pixel did
  not change; a frame equal to the one before is dropped and its
  duration added to it; the code stream is ``GifEncode.c``'s LZW at 8
  bits a pixel in 255-byte sub-blocks; a GIF of one frame is interlaced
  unless a side is under 16 pixels.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

# Quant.c's limit on distinct colours in the histogram
_MAX_HASH_ENTRIES = 65536
# Quant.c's axis weights for the box split
_AXIS_WEIGHTS = (77, 150, 29)
# GifImagePlugin: palettes of this many pixels or more are not optimised
_OPTIMIZE_AREA = 512 * 512


# ---------------------------------------------------------------------------
# median cut (Quant.c)
# ---------------------------------------------------------------------------


class _Box:
    __slots__ = ("entries", "count", "left", "right")

    def __init__(self, entries: np.ndarray, count: int):
        self.entries = entries  # indices into the histogram's colours
        self.count = count
        self.left: Optional["_Box"] = None
        self.right: Optional["_Box"] = None


class _Heap:
    """``QuantHeap.c``: a 1-indexed binary max-heap of boxes by pixel count,
    with that file's sift order (which decides ties)."""

    def __init__(self):
        self.heap: List[Optional[_Box]] = [None]

    def add(self, box: _Box) -> None:
        self.heap.append(box)
        k = len(self.heap) - 1
        while k != 1:
            if box.count - self.heap[k // 2].count <= 0:
                break
            self.heap[k] = self.heap[k // 2]
            k >>= 1
        self.heap[k] = box

    def remove(self) -> Optional[_Box]:
        heap = self.heap
        count = len(heap) - 1
        if not count:
            return None
        top = heap[1]
        v = heap.pop()
        count -= 1
        if count:
            k = 1
            while k * 2 <= count:
                child = k * 2
                if child < count and heap[child].count - heap[child + 1].count < 0:
                    child += 1
                if v.count - heap[child].count > 0:
                    break
                heap[k] = heap[child]
                k = child
            heap[k] = v
        return top


def _split(box: _Box, colours: np.ndarray, counts: np.ndarray) -> None:
    """Split a box in two (``split`` and ``splitlists``)."""
    vals = colours[box.entries]
    lo, hi = vals.min(axis=0), vals.max(axis=0)
    weighted = [int(hi[c] - lo[c]) * _AXIS_WEIGHTS[c] for c in range(3)]
    axis = 0
    for c in (1, 2):
        if weighted[axis] < weighted[c]:
            axis = c
    v = vals[:, axis]
    # the colours in descending order of the axis, their pixels summed
    levels, inverse = np.unique(v, return_inverse=True)
    per_level = np.bincount(inverse, weights=counts[box.entries]).astype(np.int64)[::-1]
    levels = levels[::-1]
    cum = np.cumsum(per_level)
    cut = int(levels[int(np.argmax(cum * 2 > box.count))])
    upper = v >= cut
    if upper.all():  # nothing below: the least value goes to the lower side
        upper = v > int(levels[-1])
    box.left = _Box(box.entries[upper], int(counts[box.entries[upper]].sum()))
    box.right = _Box(box.entries[~upper], int(counts[box.entries[~upper]].sum()))


def _volume(box: _Box, colours: np.ndarray) -> int:
    vals = colours[box.entries]
    span = vals.max(axis=0).astype(np.int64) - vals.min(axis=0) + 1
    return int(span.prod())


def _leaves(box: _Box, out: List[_Box]) -> List[_Box]:
    stack = [box]
    while stack:
        b = stack.pop()
        if b.left is None:
            out.append(b)
        else:
            stack.extend((b.right, b.left))
    return out


def quantize(rgb: np.ndarray, colors: int = 256) -> Tuple[np.ndarray, np.ndarray]:
    """``Image.fromarray(rgb).quantize(colors)`` on an (H, W, 3) uint8
    image: its (K, 3) uint8 palette and (H, W) uint8 indices."""
    h, w = rgb.shape[:2]
    px = rgb.reshape(-1, 3).astype(np.int64)
    scale = 0
    while True:
        packed = ((px[:, 0] >> scale) << 16) | ((px[:, 1] >> scale) << 8) | (px[:, 2] >> scale)
        keys, inverse, counts = np.unique(packed, return_inverse=True, return_counts=True)
        if len(keys) <= _MAX_HASH_ENTRIES:
            break
        scale += 1
    colours = np.stack([keys >> 16, (keys >> 8) & 255, keys & 255], axis=1)
    root = _Box(np.arange(len(keys)), int(px.shape[0]))
    heap = _Heap()
    heap.add(root)
    for _ in range(colors - 1):
        box = heap.remove()
        while box is not None and _volume(box, colours) == 1:
            box = heap.remove()
        if box is None:
            break
        _split(box, colours, counts)
        heap.add(box.left)
        heap.add(box.right)
    leaves = _leaves(root, [])
    box_of = np.empty(len(keys), np.int64)
    for i, leaf in enumerate(leaves):
        box_of[leaf.entries] = i
    pixel_box = box_of[inverse.ravel()]
    k = len(leaves)
    n = np.bincount(pixel_box, minlength=k).astype(np.float64)
    palette = np.stack([np.floor(0.5 + np.bincount(pixel_box, weights=px[:, c], minlength=k) / n)
                        for c in range(3)], axis=1).astype(np.int64)
    index = _nearest_from_box(px, pixel_box, palette)
    return palette.astype(np.uint8), index.astype(np.uint8).reshape(h, w)


def _nearest_from_box(px: np.ndarray, pixel_box: np.ndarray, palette: np.ndarray) -> np.ndarray:
    """``map_image_pixels_from_median_box``: each pixel's nearest palette
    entry, searched from its box's entry in the order of the entries'
    distance to that entry (then index); only a strictly nearer entry
    replaces the one found."""
    k = len(palette)
    between = ((palette[:, None, :] - palette[None, :, :]) ** 2).sum(axis=2)
    # rank[e, j]: position of entry j in entry e's (distance, index) order
    order = np.lexsort((np.broadcast_to(np.arange(k), (k, k)), between), axis=1)
    rank = np.empty_like(order)
    np.put_along_axis(rank, order, np.arange(k)[None, :].repeat(k, axis=0), axis=1)
    key = (px[:, 0] << 16) | (px[:, 1] << 8) | px[:, 2]
    uniq, first, inverse = np.unique(key, return_index=True, return_inverse=True)
    out = np.empty(len(uniq), np.int64)
    step = 8192
    for s in range(0, len(uniq), step):
        cols = px[first[s:s + step]]
        own = pixel_box[first[s:s + step]]
        d = ((cols[:, None, :] - palette[None, :, :]) ** 2).sum(axis=2)
        best = d.min(axis=1)
        pick = np.where(d == best[:, None], rank[own], k).argmin(axis=1)
        out[s:s + step] = np.where(d[np.arange(len(own)), own] == best, own, pick)
    return out[inverse.ravel()]


# ---------------------------------------------------------------------------
# Floyd-Steinberg onto a palette (Convert.c topalette, Palette.c cache)
# ---------------------------------------------------------------------------


def dither(rgb: np.ndarray, palette: np.ndarray) -> np.ndarray:
    """``Image.fromarray(rgb).quantize(palette=p)`` (Floyd-Steinberg onto
    ``p``'s (K, 3) palette) on an (H, W, 3) uint8 image: (H, W) uint8."""
    h, w = rgb.shape[:2]
    pal = palette.astype(np.int64)
    pr, pg, pb = (pal[:, c].tolist() for c in range(3))
    cache: dict = {}

    def nearest(slot: int) -> int:
        # the entry nearest the slot's corner; argmin takes the lowest index
        corner = np.array([(slot & 63) << 2, ((slot >> 6) & 63) << 2, (slot >> 12) << 2])
        best = int(((pal - corner) ** 2).sum(axis=1).argmin())
        cache[slot] = best
        return best

    out = np.empty((h, w), np.uint8)
    errors = [0] * (3 * (w + 1))
    src = rgb.reshape(h, w * 3).tolist()
    for y in range(h):
        row = src[y]
        line = [0] * w
        r = r0 = r1 = g = g0 = g1 = b = b0 = b1 = b2 = 0
        e = 0
        for x in range(w):
            # (v + error) / 16 in C: truncated toward zero
            t = r + errors[e + 3]
            r = row[3 * x] + (t >> 4 if t >= 0 else -((-t) >> 4))
            r = 0 if r <= 0 else (r if r < 256 else 255)
            t = g + errors[e + 4]
            g = row[3 * x + 1] + (t >> 4 if t >= 0 else -((-t) >> 4))
            g = 0 if g <= 0 else (g if g < 256 else 255)
            t = b + errors[e + 5]
            b = row[3 * x + 2] + (t >> 4 if t >= 0 else -((-t) >> 4))
            b = 0 if b <= 0 else (b if b < 256 else 255)
            slot = (r >> 2) | ((g >> 2) << 6) | ((b >> 2) << 12)
            idx = cache.get(slot)
            if idx is None:
                idx = nearest(slot)
            line[x] = idx
            r -= pr[idx]
            g -= pg[idx]
            b -= pb[idx]
            # the errors of the row below: 3/16 down-left, 5/16 down,
            # 1/16 down-right; 7/16 carried right in r, g, b
            r2 = r
            errors[e] = 3 * r + r0
            r0 = 5 * r + r1
            r1 = r2
            r = 7 * r
            g2 = g
            errors[e + 1] = 3 * g + g0
            g0 = 5 * g + g1
            g1 = g2
            g = 7 * g
            b2 = b
            errors[e + 2] = 3 * b + b0
            b0 = 5 * b + b1
            b1 = b2
            b = 7 * b
            e += 3
        errors[e] = b0
        errors[e + 1] = b1
        errors[e + 2] = b2
        out[y] = line
    return out


# ---------------------------------------------------------------------------
# the GIF writer (GifImagePlugin.py, GifEncode.c)
# ---------------------------------------------------------------------------

_CODE_LIMIT = 4096
# Adam7-like row order of an interlaced GIF: (first row, step)
_INTERLACE = ((0, 8), (4, 8), (2, 4), (1, 2))


def lzw(indices: np.ndarray, bits: int = 8) -> bytes:
    """``GifEncode.c``'s LZW code stream of ``indices`` (a flat uint8
    array), packed least significant bit first: a clear code first, the
    code width growing when a code past the width's largest is assigned, a
    clear code in place of the 4,096th code, an end code last."""
    clear = 1 << bits
    end = clear + 1
    out = bytearray()
    acc = nacc = 0
    table: dict = {}
    next_code, max_code, width = end + 1, 2 * clear - 1, bits + 1

    def put(code: int) -> None:
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += width
        while nacc >= 8:
            out.append(acc & 255)
            acc >>= 8
            nacc -= 8

    put(clear)
    data = indices.tolist()
    head = data[0]
    for tail in data[1:]:
        key = (head << 8) | tail
        code = table.get(key)
        if code is not None:
            head = code
            continue
        put(head)
        if next_code < _CODE_LIMIT:
            table[key] = next_code
            if next_code > max_code:
                max_code = 2 * max_code + 1
                width += 1
            next_code += 1
        else:
            put(clear)
            table.clear()
            next_code, max_code, width = end + 1, 2 * clear - 1, bits + 1
        head = tail
    put(head)
    put(end)
    if nacc:
        out.append(acc & 255)
    return bytes(out)


def _sub_blocks(stream: bytes) -> bytes:
    """The code stream in data sub-blocks of at most 255 bytes, each led by
    its length, and the zero-length block that ends the image."""
    return b"".join(bytes([len(stream[i:i + 255])]) + stream[i:i + 255]
                    for i in range(0, len(stream), 255)) + b"\x00"


def _colour_table(palette: np.ndarray) -> Tuple[int, bytes]:
    """(the size field, the table padded with black to 2 << size entries)."""
    n = len(palette)
    size = 1 if n * 3 < 9 else int(np.ceil(np.log2(n))) - 1
    table = np.zeros((2 << size, 3), np.uint8)
    table[:n] = palette
    return size, table.tobytes()


def _optimize(index: np.ndarray, palette: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``_normalize_palette`` with ``optimize``: the palette cut to the
    entries in use (and the indices renumbered) when the image has fewer
    than 512 x 512 pixels and the palette has holes or would halve."""
    if index.size >= _OPTIMIZE_AREA:
        return index, palette
    used = np.flatnonzero(np.bincount(index.ravel(), minlength=256))
    if used[-1] < len(used):
        current = 1 << (len(palette) - 1).bit_length()
        if not (len(used) <= current // 2 and current > 2):
            return index, palette
    renumber = np.zeros(256, np.uint8)
    renumber[used] = np.arange(len(used))
    return renumber[index], palette[used]


def _descriptor(x: int, y: int, w: int, h: int, flags: int) -> bytes:
    return b"," + struct.pack("<HHHHB", x, y, w, h, flags)


def _control(duration: int, transparency: Optional[int]) -> bytes:
    centis = int(duration / 10)
    if transparency is None and centis == 0:
        return b""
    return b"!\xf9\x04" + struct.pack("<BHBB", int(transparency is not None), centis,
                                      transparency or 0, 0)


def _header(w: int, h: int, palette: np.ndarray, loop: int) -> bytes:
    size, table = _colour_table(palette)
    return (b"GIF89a" + struct.pack("<HHBBB", w, h, size + 128, 0, 0) + table
            + b"!\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", loop) + b"\x00")


def encode_gif(frames: Sequence[np.ndarray], duration: int, loop: int = 0) -> bytes:
    """The GIF file Pillow writes for ``frames`` (each (H, W, 3) uint8 RGB)
    as ``frames_to_gif`` builds them: the first quantised to 256 colours,
    the others dithered onto its palette, saved with ``save_all``,
    ``duration`` (ms) and ``loop``. The first frame sets the canvas; a
    frame of another size is compared with the one before over the area
    they share, as Pillow does."""
    palette, first = quantize(frames[0])
    h, w = first.shape
    kept = []  # [index, palette, bbox, transparency, duration]
    prev = None
    for k, rgb in enumerate(frames):
        index = first if k == 0 else dither(rgb, palette)
        index, pal = _optimize(index, palette)
        if prev is None:
            kept.append([index, pal, None, None, duration])
            prev = (index, pal)
            continue
        # Pillow's difference of two frames covers the area they share
        mh, mw = min(index.shape[0], prev[0].shape[0]), min(index.shape[1], prev[0].shape[1])
        cur, old = index[:mh, :mw], prev[0][:mh, :mw]
        if np.array_equal(pal, prev[1]):
            changed = cur != old
        else:  # compared as colours (RGBA) where the palettes differ
            changed = (pal[cur] != prev[1][old]).any(axis=2)
        if not changed.any():
            kept[-1][4] += duration
            continue
        ys, xs = np.nonzero(changed)
        bbox = (int(xs.min()), int(ys.min()), int(xs.max()) + 1, int(ys.max()) + 1)
        trans = len(pal)
        if trans >= 256:
            free = np.flatnonzero(np.bincount(index.ravel(), minlength=256) == 0)
            trans = int(free[-1]) if free.size else None
        diff = index
        if trans is not None:
            diff = index.copy()
            diff[:mh, :mw] = np.where(changed, cur, np.uint8(trans))
        kept.append([diff, pal, bbox, trans, duration])
        prev = (index, pal)
    if len(kept) == 1:
        # one frame: Pillow's single-frame path, interlaced unless a side
        # is under 16 pixels
        index, pal, _, _, total = kept[0]
        interlace = min(h, w) >= 16
        rows = np.concatenate([index[r::s] for r, s in _INTERLACE]) if interlace else index
        return (_header(w, h, pal, loop) + _control(total, None)
                + _descriptor(0, 0, w, h, 64 if interlace else 0) + b"\x08"
                + _sub_blocks(lzw(rows.ravel())) + b";")
    out = [_header(w, h, kept[0][1], loop)]
    for index, pal, bbox, trans, total in kept:
        if bbox is None:
            out += [_control(total, trans), _descriptor(0, 0, w, h, 0), b"\x08",
                    _sub_blocks(lzw(index.ravel()))]
            continue
        x0, y0, x1, y1 = bbox
        size, table = _colour_table(pal)
        out += [_control(total, trans), _descriptor(x0, y0, x1 - x0, y1 - y0, 128 | size),
                table, b"\x08", _sub_blocks(lzw(np.ascontiguousarray(index[y0:y1, x0:x1]).ravel()))]
    return b"".join(out) + b";"
