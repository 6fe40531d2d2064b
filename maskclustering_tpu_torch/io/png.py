"""PNG codec on the standard library's ``zlib`` and numpy.

The scan layouts store depth and mask id-maps as PNG files. The JAX
package reads them with cv2 or PIL; the port has neither (the card's
machine ships only torch, numpy and scipy), so this module decodes and
encodes the formats the layouts use: 8- and 16-bit samples, grey, grey
with alpha, RGB and RGBA (colour types 0, 4, 2, 6), not interlaced. A
palette, a bit depth below 8 or Adam7 interlacing raises ``ValueError``
there; ``decode_png_rgb`` reads every colour type and bit depth (the
palette and low-bit files a directory of debug images may hold) as RGB,
and Adam7 alone raises.

The reader undoes all five row filters of the PNG specification (§9).
None, Sub and Up need nothing but the row or the row above; Average and
Paeth depend on the reconstructed byte to the left, which makes a row a
left-to-right recurrence. Sub rows are a running sum along the row, all
rows at once, and Up rows add the row above in order (cv2 writes Sub rows;
this module's writer filter 0). A Paeth row is decoded whole given the row
above: where the byte above equals the one above-left, the predictor picks
the left byte, so the row is a running sum there; only the other bytes (a
few an edge in an id-map, as PIL writes them) are resolved one by one.
Average rows, and files whose Paeth rows hold too many such bytes (noise,
photos), go through a wavefront instead: byte (r, x) needs (r, x - bpp),
(r - 1, x) and (r - 1, x - bpp) only, so every pixel on one anti-diagonal
r + p is independent of the others. The image is stored skewed (pixel p of
row r at column r + p) and decoded one diagonal a step, each step one
vectorised numpy pass over every row: H + W - 1 steps instead of H * W.

The writer ``encode_png`` uses filter 0 on every row unless asked for
another filter (any of the five, or one per row), which the tests and
``chip_smoke.py`` use to build files of each kind. Two more writers give
the bytes of the JAX package's writers: ``encode_png_libpng`` those of
cv2's ``imwrite`` (its depth frames) and ``encode_png_pillow`` those of
PIL's ``save`` (its mask id-maps and RGB debug images); both run the standard library's zlib
with the parameters and row filters those libraries choose.
"""

from __future__ import annotations

import struct
import zlib
from typing import Iterator, NamedTuple, Tuple

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples a pixel
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}  # samples a pixel -> colour type


class PngHeader(NamedTuple):
    width: int
    height: int
    bit_depth: int
    color_type: int
    interlace: int


def _chunks(data: bytes) -> Iterator[Tuple[bytes, bytes]]:
    """(type, payload) of each chunk, CRC checked."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ValueError(f"truncated PNG chunk {kind!r}")
        payload = data[pos + 8:end]
        (crc,) = struct.unpack(">I", data[end:end + 4])
        if zlib.crc32(kind + payload) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, payload
        if kind == b"IEND":
            return
        pos = end + 4
    raise ValueError("PNG file ends before its IEND chunk")


def _parse_header(payload: bytes) -> PngHeader:
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB", payload)
    if comp != 0 or filt != 0:
        raise ValueError(f"unknown PNG compression {comp} or filter method {filt}")
    return PngHeader(w, h, depth, ctype, interlace)


def read_png_header(path: str) -> PngHeader:
    """The IHDR fields of a PNG file, reading only its first 33 bytes."""
    with open(path, "rb") as f:
        head = f.read(33)
    if head[:8] != SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path} is not a PNG file")
    return _parse_header(head[16:29])


def png_size(path: str) -> Tuple[int, int]:
    """(width, height) of a PNG file, from its header."""
    hdr = read_png_header(path)
    return hdr.width, hdr.height


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The Paeth predictor (PNG §9.4) of int16 byte values."""
    pa = np.abs(b - c)
    pb = np.abs(a - c)
    pc = np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _lane_cumsum(row: np.ndarray, bpp: int) -> np.ndarray:
    """Running sum mod 256 of each byte lane of a flat uint8 row."""
    return np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)


def _paeth_row(raw: np.ndarray, above: np.ndarray, bpp: int, budget: int):
    """Decode one Paeth row: ``raw`` its flat filtered bytes, ``above`` the
    decoded row above. Returns (row, n): n counts the bytes whose above
    byte differs from the above-left one (only those can pick another
    predictor than the left byte, and each is resolved in turn); the row is
    None when n exceeds ``budget``."""
    upleft = np.zeros_like(above)
    upleft[bpp:] = above[:-bpp]
    idx = np.flatnonzero(above != upleft)
    # where the left byte is the predictor, a byte is the running sum of
    # its lane plus an offset that changes only at the resolved bytes
    csum = _lane_cumsum(raw, bpp)
    n = idx.size
    if n == 0 or n > budget:
        return (csum if n == 0 else None), n
    offset = [0] * bpp
    steps = []
    for j, r, b, c, cs in zip(idx.tolist(), raw[idx].tolist(), above[idx].tolist(),
                              upleft[idx].tolist(), csum[idx].tolist()):
        lane = j % bpp
        a = (cs - r + offset[lane]) & 255  # the left byte, as resolved
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        v = (r + (a if pa <= pb and pa <= pc else b if pb <= pc else c)) & 255
        step = (v - cs - offset[lane]) & 255
        steps.append(step)
        offset[lane] = (offset[lane] + step) & 255
    delta = np.zeros_like(raw)
    delta[idx] = steps
    return csum + _lane_cumsum(delta, bpp), n


def _unfilter_wavefront(ftype: np.ndarray, data: np.ndarray, bpp: int) -> np.ndarray:
    """Undo any mix of row filters, one anti-diagonal a step."""
    h, stride = data.shape
    w = stride // bpp
    x = data.reshape(h, w, bpp).astype(np.int16)
    # skewed layout: byte (r, p) of the image sits at column r + p + 2 of
    # row r + 1; row 0 and the two leading columns stay 0, which is what
    # the filters read above the first row and left of the first pixel
    cols = h + w + 1
    recon = np.zeros((h + 1, cols, bpp), np.int16)
    skewed = np.zeros((h, cols, bpp), np.int16)
    for r in range(h):
        skewed[r, r + 2:r + 2 + w] = x[r]
    # one (H, 1, 1) row mask a filter type present
    masks = [(k, (ftype == k)[:, None, None]) for k in range(1, 5) if (ftype == k).any()]
    for d in range(h + w - 1):  # the anti-diagonal r + p = d
        r0, r1 = max(0, d - w + 1), min(h - 1, d)
        c = d + 2
        left = recon[r0 + 1:r1 + 2, c - 1]
        up = recon[r0:r1 + 1, c - 1]
        pred = 0
        for k, m in masks:
            if k == 1:
                kth = left
            elif k == 2:
                kth = up
            elif k == 3:
                kth = (left + up) >> 1
            else:
                kth = _paeth(left, up, recon[r0:r1 + 1, c - 2])
            pred = np.where(m[r0:r1 + 1, 0], kth, pred)
        recon[r0 + 1:r1 + 2, c] = (skewed[r0:r1 + 1, c] + pred) & 255
    out = np.empty((h, w, bpp), np.uint8)
    for r in range(h):
        out[r] = recon[r + 1, r + 2:r + 2 + w]
    return out.reshape(h, stride)


def unfilter(scanlines: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the row filters: (H, 1 + stride) uint8 scanlines, each led by
    its filter type, to the (H, stride) uint8 image bytes; ``bpp`` is the
    bytes of one pixel (the filters' left distance)."""
    ftype = scanlines[:, 0]
    data = scanlines[:, 1:]
    if (ftype > 4).any():
        raise ValueError(f"unknown PNG filter type {int(ftype.max())}")
    if not ftype.any():
        return np.ascontiguousarray(data)
    h, stride = data.shape
    w = stride // bpp
    if (ftype == 3).any():
        return _unfilter_wavefront(ftype, data, bpp)
    # Sub is a running sum of each byte lane (uint8 wraps mod 256), for
    # every row at once; Up and Paeth rows then follow the row above, in
    # order. Past this many bytes resolved one by one, the wavefront is
    # the cheaper way through the rest of the file.
    budget = 16 * (h + w)
    sub = ftype == 1
    if sub.all():
        return np.cumsum(data.reshape(h, w, bpp), axis=1, dtype=np.uint8).reshape(h, stride)
    out = data.reshape(h, w, bpp).copy()
    out[sub] = np.cumsum(out[sub], axis=1, dtype=np.uint8)
    out = out.reshape(h, stride)
    zero = np.zeros(stride, np.uint8)
    for r in np.flatnonzero(ftype >= 2).tolist():
        above = out[r - 1] if r else zero
        if ftype[r] == 2:
            out[r] += above
            continue
        row, n = _paeth_row(out[r], above, bpp, budget)
        if row is None:
            return _unfilter_wavefront(ftype, data, bpp)
        budget -= n
        out[r] = row
    return out.reshape(h, stride)


def _decode_rows(data: bytes, accept) -> Tuple[PngHeader, np.ndarray, bytes]:
    """(header, unfiltered (H, stride) bytes, PLTE payload) of a PNG file
    whose (colour type, bit depth) ``accept`` takes; a sample narrower than
    a byte unfilters with one byte a pixel, as the specification says."""
    hdr = None
    idat = []
    palette = b""
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            hdr = _parse_header(payload)
        elif kind == b"PLTE":
            palette = payload
        elif kind == b"IDAT":
            idat.append(payload)
    if hdr is None:
        raise ValueError("PNG file has no IHDR chunk")
    accept(hdr)
    if hdr.interlace:
        raise ValueError("interlaced PNG files are not supported")
    ch = 1 if hdr.color_type == 3 else _CHANNELS[hdr.color_type]
    bits = ch * hdr.bit_depth
    bpp = max(1, bits // 8)
    stride = (hdr.width * bits + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != hdr.height * (stride + 1):
        raise ValueError(f"PNG image data holds {raw.size} bytes, expected "
                         f"{hdr.height * (stride + 1)}")
    return hdr, unfilter(raw.reshape(hdr.height, stride + 1), bpp), palette


def _accept_8_16(hdr: PngHeader) -> None:
    if hdr.color_type not in _CHANNELS or hdr.bit_depth not in (8, 16):
        raise ValueError(f"unsupported PNG format: colour type {hdr.color_type}, "
                         f"bit depth {hdr.bit_depth} (8- or 16-bit grey, grey+alpha, "
                         f"RGB or RGBA only)")


def _samples(hdr: PngHeader, rows: np.ndarray) -> np.ndarray:
    """(H, W, C) samples of unfiltered rows; uint16 for 16-bit files."""
    ch = _CHANNELS[hdr.color_type]
    img = rows.view(">u2").astype(np.uint16) if hdr.bit_depth == 16 else rows
    return img.reshape(hdr.height, hdr.width, ch)


def decode_png(data: bytes) -> np.ndarray:
    """A PNG file's pixels: (H, W) for grey, (H, W, C) otherwise; uint8 or
    uint16 (16-bit samples in native byte order)."""
    hdr, rows, _ = _decode_rows(data, _accept_8_16)
    img = _samples(hdr, rows)
    return img[:, :, 0] if img.shape[2] == 1 else img


# PIL's scaling of grey samples narrower than a byte to 8 bits ("1" is 0/255)
_GREY_SCALE = {1: 255, 2: 85, 4: 17}


def _accept_any(hdr: PngHeader) -> None:
    legal = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
    if hdr.bit_depth not in legal.get(hdr.color_type, ()):
        raise ValueError(f"not a valid PNG format: colour type {hdr.color_type}, "
                         f"bit depth {hdr.bit_depth}")


def decode_png_rgb(data: bytes) -> np.ndarray:
    """A PNG file as (H, W, 3) uint8 RGB, what PIL's ``Image.open(f).convert(
    "RGB")`` gives: any colour type and bit depth, not interlaced. A palette
    is looked up (an index past it is black); grey narrower than a byte is
    scaled to 8 bits, 16-bit grey is clipped to 255, other 16-bit samples
    keep their high byte; alpha is dropped."""
    hdr, rows, palette = _decode_rows(data, _accept_any)
    if hdr.bit_depth < 8:
        bits = hdr.bit_depth
        per = 8 // bits
        shifts = (8 - bits * (1 + np.arange(per))).astype(np.uint8)
        vals = (rows[:, :, None] >> shifts) & ((1 << bits) - 1)
        idx = vals.reshape(hdr.height, -1)[:, :hdr.width]
    elif hdr.color_type == 3:
        idx = rows
    else:
        img = _samples(hdr, rows)
        if hdr.bit_depth == 16:
            img = (np.minimum(img, 255) if hdr.color_type == 0 else img >> 8).astype(np.uint8)
        if img.shape[2] >= 3:
            return np.ascontiguousarray(img[:, :, :3])
        return np.repeat(img[:, :, :1], 3, axis=2)
    if hdr.color_type == 3:
        table = np.zeros((256, 3), np.uint8)
        entries = np.frombuffer(palette[:len(palette) // 3 * 3], np.uint8).reshape(-1, 3)
        table[:min(len(entries), 256)] = entries[:256]
        return table[idx]
    grey = (idx * _GREY_SCALE[hdr.bit_depth]).astype(np.uint8)
    return np.repeat(grey[:, :, None], 3, axis=2)


def read_png(path: str) -> np.ndarray:
    """Decode the PNG file at ``path`` (see :func:`decode_png`)."""
    with open(path, "rb") as f:
        return decode_png(f.read())


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF))


def _residuals(raw: np.ndarray, bpp: int, kinds) -> dict:
    """{filter type: the (H, stride) uint8 bytes minus that filter's
    prediction, mod 256} for each type in ``kinds``. Each filter predicts
    from the unfiltered bytes, so all rows go at once."""
    x = raw.astype(np.int16)
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    out = {}
    for k in kinds:
        if k == 4:
            upleft = np.zeros_like(x)
            upleft[1:, bpp:] = x[:-1, :-bpp]
            pred = _paeth(left, up, upleft)
        else:
            pred = (0, left, up, (left + up) >> 1)[k]
        out[k] = ((x - pred) & 255).astype(np.uint8)
    return out


def _scanlines_of(types: np.ndarray, res: dict) -> np.ndarray:
    """(H, 1 + stride) scanlines: row r is filter ``types[r]``'s residuals."""
    rows = np.empty((types.size, next(iter(res.values())).shape[1] + 1), np.uint8)
    rows[:, 0] = types
    for k, r in res.items():
        pick = types == k
        rows[pick, 1:] = r[pick]
    return rows


def _filter_rows(raw: np.ndarray, bpp: int, filters) -> np.ndarray:
    """Apply the row filters: (H, stride) uint8 image bytes to (H, 1 +
    stride) scanlines; ``filters`` is one type for every row or one a row."""
    types = np.broadcast_to(np.asarray(filters, np.uint8), (raw.shape[0],))
    if (types > 4).any():
        raise ValueError(f"PNG filter types are 0-4, got {sorted(set(types.tolist()))}")
    return _scanlines_of(types, _residuals(raw, bpp, sorted(set(types.tolist()))))


def _scanlines(img: np.ndarray) -> Tuple[np.ndarray, int, bytes]:
    """(H, stride) image bytes, bytes a pixel and the IHDR payload of a
    uint8 or uint16 image, (H, W) grey or (H, W, C) with C in 1-4."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        depth = 8
    elif img.dtype == np.uint16:
        depth = 16
    else:
        raise ValueError(f"PNG images are uint8 or uint16, got {img.dtype}")
    if img.ndim == 2:
        img = img[:, :, None]
    if img.ndim != 3 or img.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"PNG images are (H, W) or (H, W, 1-4), got {img.shape}")
    h, w, ch = img.shape
    data = img.astype(">u2") if depth == 16 else img
    raw = np.ascontiguousarray(data).view(np.uint8).reshape(h, -1)
    header = struct.pack(">IIBBBBB", w, h, depth, _COLOR_TYPE[ch], 0, 0, 0)
    return raw, ch * depth // 8, header


def _file(header: bytes, stream: bytes, idat_size: int) -> bytes:
    idat = [_chunk(b"IDAT", stream[i:i + idat_size])
            for i in range(0, max(len(stream), 1), idat_size)]
    return SIGNATURE + _chunk(b"IHDR", header) + b"".join(idat) + _chunk(b"IEND", b"")


def encode_png(img: np.ndarray, level: int = 6, filters=0) -> bytes:
    """PNG file bytes of a uint8 or uint16 image, (H, W) grey or (H, W, C)
    with C in 1-4; row filter ``filters`` (a type 0-4, or one a row), zlib
    at ``level``."""
    raw, bpp, header = _scanlines(img)
    rows = _filter_rows(raw, bpp, filters)
    return _file(header, zlib.compress(rows.tobytes(), level), 1 << 30)


def encode_png_libpng(img: np.ndarray) -> bytes:
    """The bytes cv2's ``imwrite`` writes through libpng with OpenCV's
    defaults: the Sub filter on every row, zlib level 1 with ``Z_RLE``,
    libpng's window cut to the data (``png_deflate_claim``) and its
    stream header rewritten for it (``optimize_cmf``), 8192-byte IDATs.
    libpng drops Sub for an image one pixel wide and writes None."""
    raw, bpp, header = _scanlines(img)
    data = _filter_rows(raw, bpp, 1 if raw.shape[1] > bpp else 0).tobytes()
    wbits, size = 15, len(data)
    if size <= 16384:
        half = 1 << (wbits - 1)
        while size + 262 <= half:
            half >>= 1
            wbits -= 1
    z = zlib.compressobj(1, zlib.DEFLATED, wbits, 8, zlib.Z_RLE)
    stream = bytearray(z.compress(data) + z.flush())
    if size <= 16384 and (stream[0] & 0x0F) == 8 and (stream[0] & 0xF0) <= 0x70:
        cinfo = stream[0] >> 4
        half = 1 << (cinfo + 7)
        if size <= half:
            while True:
                half >>= 1
                cinfo -= 1
                if not (cinfo > 0 and size <= half):
                    break
            cmf = (stream[0] & 0x0F) | (cinfo << 4)
            flg = stream[1] & 0xE0
            flg += 0x1F - ((cmf << 8) + flg) % 0x1F
            stream[0], stream[1] = cmf, flg
    return _file(header, bytes(stream), 8192)


def _pillow_rows(raw: np.ndarray, bpp: int) -> np.ndarray:
    """The scanlines of Pillow's ``ZipEncode.c`` choice of a row filter: the
    least sum of byte distances from zero, tried in the order None, Up,
    Sub, Paeth, a later one only when strictly less and the sum so far is
    not 0."""
    res = _residuals(raw, bpp, (0, 2, 1, 4))
    types = np.zeros(raw.shape[0], np.uint8)
    best = None
    for ftype, v in res.items():
        v = v.astype(np.int32)
        c = np.minimum(v, 256 - v).sum(axis=1)
        if best is None:
            best = c
            continue
        take = (best > 0) & (c < best)
        types[take] = ftype
        best = np.where(take, c, best)
    return _scanlines_of(types, res)


def encode_png_pillow(img: np.ndarray) -> bytes:
    """The bytes ``PIL.Image.fromarray(img).save(path)`` writes for a
    uint8 grey or RGB image or a 16-bit grey one with Pillow's defaults: its adaptive row
    filter, zlib level 6 with ``Z_FILTERED`` and memory level 9, IDATs of
    ``max(65536, 4 * width)`` bytes."""
    raw, bpp, header = _scanlines(img)
    data = _pillow_rows(raw, bpp).tobytes()
    z = zlib.compressobj(6, zlib.DEFLATED, 15, 9, zlib.Z_FILTERED)
    return _file(header, z.compress(data) + z.flush(), max(65536, 4 * raw.shape[1] // bpp))


def write_png(path: str, img: np.ndarray, level: int = 6, filters=0) -> None:
    """Write ``img`` as a PNG file (see :func:`encode_png`)."""
    with open(path, "wb") as f:
        f.write(encode_png(img, level, filters))
