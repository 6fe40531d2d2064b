"""Baseline JPEG codec in numpy: the colour frames of every scan layout.

The decoder is held pixel for pixel to libjpeg-turbo's default decode,
which PIL and cv2 both run, so ``io/image.read_rgb`` gives the JAX
package's pixels (``maskclustering_tpu/io/image.py:49-56``) without either
library. It follows libjpeg-turbo's defaults step by step:

- **entropy decode** of sequential Huffman scans (SOF0, SOF1) at 8 bits:
  one or more scans, interleaved or not, restart intervals (DRI, RSTn),
  byte stuffing and fill bytes. It is the one sequential part: a table of
  all 65,536 16-bit peeks gives, in one lookup, the code length, the zero
  run and, where it fits in the peek, the coefficient itself;
- **dequantisation and the islow integer IDCT** (``jidctint.c``:
  ``CONST_BITS`` 13, ``PASS1_BITS`` 2), vectorised over all blocks of a
  component. The output saturates to 0..255 as the SIMD IDCT that PIL and
  cv2 run on x86 does, where the C code's range-limit table wraps. Blocks
  whose intermediates overflow 16 bits, which no encoder makes from 8-bit
  samples, are where the SIMD and C versions part further; the port
  follows neither there;
- **fancy upsampling** (``jdsample.c``): h2v1 with its alternating +1/+2
  bias, h2v2 as the triangle filter (vertical first, then horizontal with
  +8/+7 and ``>> 4``), h1v2 with +1/+2; box replication where libjpeg
  takes it (a chroma plane 2 or fewer samples wide). Edges replicate at
  the component's own width and height; partial MCUs are cropped last;
- **YCbCr to RGB** with ``jdcolor.c``'s fixed-point tables (``SCALEBITS``
  16). The colour space is chosen as libjpeg does: JFIF means YCbCr, else
  the Adobe APP14 transform flag, else the component ids ('R', 'G', 'B'
  means RGB).

Progressive, arithmetic-coded, lossless and hierarchical files, 12-bit
samples and 2- or 4-component (CMYK) images raise ``NotImplementedError``
naming the file and the SOF marker; a truncated or corrupt stream raises
``ValueError``. Neither is ever returned as a wrong image.

The encoder writes baseline 4:2:0 files with libjpeg's quality-scaled
Annex K tables (``jcparam.c``) and the standard Huffman tables. It is not
byte-equal to libjpeg's (its forward DCT and colour conversion are
float64), only a valid file of the same kind.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import numpy as np

# the ROADMAP item that would decode the JPEG kinds refused here
_UNSUPPORTED_ITEM = "ROADMAP.md queue A, item A17"

# natural (row-major) index of zig-zag position k; positions past 63 (a
# corrupt run) land on 63, as libjpeg's padded jpeg_natural_order does
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], dtype=np.int64)
_ZIGZAG_PADDED = _ZIGZAG.tolist() + [63] * 16

_SOF_NAMES = {
    0xC0: "SOF0 (baseline)", 0xC1: "SOF1 (extended sequential)", 0xC2: "SOF2 (progressive)",
    0xC3: "SOF3 (lossless)", 0xC5: "SOF5 (differential sequential)",
    0xC6: "SOF6 (differential progressive)", 0xC7: "SOF7 (differential lossless)",
    0xC9: "SOF9 (arithmetic sequential)", 0xCA: "SOF10 (arithmetic progressive)",
    0xCB: "SOF11 (arithmetic lossless)", 0xCD: "SOF13 (arithmetic differential sequential)",
    0xCE: "SOF14 (arithmetic differential progressive)",
    0xCF: "SOF15 (arithmetic differential lossless)"}


def _refuse(name: str, sof: str, what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{name}: {what} ({sof}) is not decoded by the port's JPEG codec, which reads "
        f"baseline and extended-sequential Huffman JPEG at 8 bits with 1 or 3 components: "
        f"{_UNSUPPORTED_ITEM}")


# ---------------------------------------------------------------------------
# Huffman tables
# ---------------------------------------------------------------------------


def _canonical_codes(bits: bytes, vals: bytes) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(codes, lengths, symbols) of a DHT table, in the standard's order."""
    codes, lengths = [], []
    code = 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes.append(code)
            lengths.append(length)
            code += 1
        code <<= 1
    n = len(codes)
    if n != len(vals) or n > 256:
        raise ValueError("corrupt JPEG: a Huffman table's counts and symbols disagree")
    return (np.asarray(codes, np.int64), np.asarray(lengths, np.int64),
            np.frombuffer(bytes(vals), np.uint8).astype(np.int64))


def _peek_tables(bits: bytes, vals: bytes) -> Tuple[np.ndarray, np.ndarray]:
    """(code length, symbol) for every 16-bit peek; length 0 = no code."""
    codes, lengths, syms = _canonical_codes(bits, vals)
    length_of = np.zeros(1 << 16, np.int64)
    sym_of = np.zeros(1 << 16, np.int64)
    for c, n, s in zip(codes.tolist(), lengths.tolist(), syms.tolist()):
        if c >= (1 << n):
            raise ValueError("corrupt JPEG: a Huffman table overflows its code space")
        lo = c << (16 - n)
        hi = (c + 1) << (16 - n)
        length_of[lo:hi] = n
        sym_of[lo:hi] = s
    return length_of, sym_of


def _extend(bits: np.ndarray, size: np.ndarray) -> np.ndarray:
    """The JPEG sign extension of ``size`` received bits (F.2.2.1)."""
    half = np.where(size > 0, np.left_shift(1, np.maximum(size - 1, 0)), 1)
    return np.where(bits < half, bits - np.left_shift(1, size) + 1, bits)


@functools.lru_cache(maxsize=32)
def _dc_lookup(bits: bytes, vals: bytes) -> List[Tuple[int, int]]:
    """Per 16-bit peek: ``(bits consumed, DC difference)`` when the code and
    its extra bits fit in the peek; ``(-code length, size)`` when the extra
    bits lie beyond it; ``(0, 0)`` for no code."""
    length, size = _peek_tables(bits, vals)
    peek = np.arange(1 << 16, dtype=np.int64)
    fits = (length > 0) & (length + size <= 16)
    extra = (peek >> np.maximum(16 - length - size, 0)) & ((1 << size) - 1)
    value = np.where(size > 0, _extend(extra, size), 0)
    nb = np.where(fits, length + size, -length)
    v = np.where(fits, value, size)
    return list(zip(nb.tolist(), v.tolist()))


@functools.lru_cache(maxsize=32)
def _ac_lookup(bits: bytes, vals: bytes) -> List[Tuple[int, int, int]]:
    """Per 16-bit peek: ``(bits consumed, zero run, coefficient)``.

    A symbol of size 0 is ZRL (run 15, then the coefficient slot is
    skipped) when its run is 15 and end-of-block otherwise (run 64), as
    libjpeg's decode_mcu reads it. ``(-code length, run, size)`` marks a
    coefficient whose extra bits lie beyond the peek; ``(0, 0, 0)`` no code.
    """
    length, sym = _peek_tables(bits, vals)
    run, size = sym >> 4, sym & 15
    peek = np.arange(1 << 16, dtype=np.int64)
    extra = (peek >> np.maximum(16 - length - size, 0)) & ((1 << size) - 1)
    value = np.where(size > 0, _extend(extra, size), 0)
    eob = (size == 0) & (run != 15)
    fits = (length > 0) & (length + size <= 16)
    nb = np.where(fits, length + size, -length)
    r = np.where(eob, 64, run)
    v = np.where(fits, value, size)
    return list(zip(nb.tolist(), r.tolist(), v.tolist()))


# ---------------------------------------------------------------------------
# entropy decode
# ---------------------------------------------------------------------------


def _bit_windows(segment: bytes) -> List[int]:
    """Unstuffed entropy bytes -> the big-endian 32-bit word at every byte,
    with zero bytes past the end (libjpeg's fill past a marker)."""
    a = np.frombuffer(segment + bytes(8), np.uint8).astype(np.int64)
    return ((a[:-3] << 24) | (a[1:-2] << 16) | (a[2:-1] << 8) | a[3:]).tolist()


def _decode_interval(win: List[int], nbits: int, comp: List[int], base: List[int],
                     dc_luts: List, ac_luts: List, ncomp: int,
                     out_idx: List[int], out_val: List[int]) -> None:
    """Entropy-decode the blocks of one restart interval, in scan order.

    ``comp[j]`` is block j's slot among the scan's components and
    ``base[j]`` its offset in the coefficient buffer. Coefficients are
    appended as (natural index + base, value); DC predictors start at 0.
    """
    zz = _ZIGZAG_PADDED
    put_idx, put_val = out_idx.append, out_val.append
    pred = [0] * ncomp
    pos = 0
    for c, b in zip(comp, base):
        nb, v = dc_luts[c][(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
        if nb > 0:
            pos += nb
        elif nb < 0:
            pos -= nb
            s = v
            bits = (win[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
            v = bits if bits >> (s - 1) else bits - (1 << s) + 1
            pos += s
        else:
            raise ValueError("corrupt JPEG data: bad Huffman code")
        v += pred[c]
        pred[c] = v
        put_idx(b)
        put_val(v)
        lut = ac_luts[c]
        k = 1
        while k < 64:
            nb, r, v = lut[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
            if nb > 0:
                pos += nb
                k += r
                if v:
                    put_idx(b + zz[k])
                    put_val(v)
                k += 1
            elif nb < 0:
                pos -= nb
                s = v
                bits = (win[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                pos += s
                k += r
                put_idx(b + zz[k])
                put_val(bits if bits >> (s - 1) else bits - (1 << s) + 1)
                k += 1
            else:
                raise ValueError("corrupt JPEG data: bad Huffman code")
    if pos > nbits:
        raise ValueError("truncated JPEG: the entropy-coded data ends inside a block")


def _scan_segments(data: bytes, start: int, name: str) -> Tuple[List[bytes], int]:
    """Split a scan's entropy-coded data at its RSTn markers: the unstuffed
    bytes of each restart interval and the offset of the marker that ends
    the scan."""
    segments = []
    seg_start = i = start
    n = len(data)
    while True:
        j = data.find(b"\xff", i)
        if j < 0:
            raise ValueError(f"truncated JPEG {name}: the data ends inside a scan")
        k = j + 1
        while k < n and data[k] == 0xFF:
            k += 1  # fill bytes
        if k >= n:
            raise ValueError(f"truncated JPEG {name}: the data ends inside a scan")
        m = data[k]
        if m == 0x00:  # a stuffed 0xFF data byte
            i = k + 1
            continue
        segments.append(data[seg_start:j].replace(b"\xff\x00", b"\xff"))
        if 0xD0 <= m <= 0xD7:
            seg_start = i = k + 1
            continue
        return segments, j


# ---------------------------------------------------------------------------
# IDCT, upsampling, colour
# ---------------------------------------------------------------------------

_FIX_0_298631336 = 2446
_FIX_0_390180644 = 3196
_FIX_0_541196100 = 4433
_FIX_0_765366865 = 6270
_FIX_0_899976223 = 7373
_FIX_1_175875602 = 9633
_FIX_1_501321110 = 12299
_FIX_1_847759065 = 15137
_FIX_1_961570560 = 16069
_FIX_2_053119869 = 16819
_FIX_2_562915447 = 20995
_FIX_3_072711026 = 25172
_CONST_BITS = 13
_PASS1_BITS = 2


def _idct_1d(x):
    """One islow pass over the 8 inputs ``x[0..7]`` (int64 arrays): the 8
    outputs before descaling, ``jidctint.c`` term for term."""
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * _FIX_0_541196100
    tmp2 = z1 - z3 * _FIX_1_847759065
    tmp3 = z1 + z2 * _FIX_0_765366865
    tmp0 = (x[0] + x[4]) << _CONST_BITS
    tmp1 = (x[0] - x[4]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2

    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _FIX_1_175875602
    t0 = t0 * _FIX_0_298631336
    t1 = t1 * _FIX_2_053119869
    t2 = t2 * _FIX_3_072711026
    t3 = t3 * _FIX_1_501321110
    z1 = z1 * -_FIX_0_899976223
    z2 = z2 * -_FIX_2_562915447
    z3 = z3 * -_FIX_1_961570560 + z5
    z4 = z4 * -_FIX_0_390180644 + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    return (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)


def idct_islow(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """(n, 64) natural-order coefficients and a (64,) natural-order table ->
    (n, 8, 8) uint8 samples, bit-equal to libjpeg-turbo's islow IDCT.

    Its all-zero-AC shortcuts give the same values as the full formula, so
    they need no branch here.
    """
    blocks = (coef.astype(np.int64) * quant.astype(np.int64)).reshape(-1, 8, 8)
    # pass 1: columns (the 8 rows of each column), descaled to PASS1_BITS
    s = _CONST_BITS - _PASS1_BITS
    ws = np.stack([(o + (1 << (s - 1))) >> s
                   for o in _idct_1d([blocks[:, r, :] for r in range(8)])], axis=1)
    # pass 2: rows of the workspace, descaled by 8 and PASS1_BITS
    s = _CONST_BITS + _PASS1_BITS + 3
    out = np.stack([(o + (1 << (s - 1))) >> s
                    for o in _idct_1d([ws[:, :, c] for c in range(8)])], axis=2)
    # + CENTERJSAMPLE, saturated as the SIMD IDCT's packs do
    return np.clip(out + 128, 0, 255).astype(np.uint8)


def _shift_rows(a: np.ndarray, step: int) -> np.ndarray:
    """Row r of the result is row r + step of ``a``, edges replicated."""
    if step < 0:
        return np.concatenate([a[:1], a[:-1]], axis=0)
    return np.concatenate([a[1:], a[-1:]], axis=0)


def _shift_cols(a: np.ndarray, step: int) -> np.ndarray:
    if step < 0:
        return np.concatenate([a[:, :1], a[:, :-1]], axis=1)
    return np.concatenate([a[:, 1:], a[:, -1:]], axis=1)


def _interleave(even: np.ndarray, odd: np.ndarray, axis: int) -> np.ndarray:
    out = np.stack([even, odd], axis=axis + 1)
    shape = list(even.shape)
    shape[axis] *= 2
    return out.reshape(shape)


def upsample(plane: np.ndarray, h_ratio: int, v_ratio: int) -> np.ndarray:
    """libjpeg-turbo's fancy upsampling of one component plane (cropped to
    its own width and height) by (h_ratio, v_ratio) in {1, 2}."""
    a = plane.astype(np.int64)
    width = a.shape[1]
    if (h_ratio, v_ratio) == (1, 1):
        return plane
    if (h_ratio, v_ratio) == (2, 1):
        if width <= 2:  # libjpeg takes box replication here
            return np.repeat(plane, 2, axis=1)
        even = (3 * a + _shift_cols(a, -1) + 1) >> 2
        odd = (3 * a + _shift_cols(a, 1) + 2) >> 2
        return _interleave(even, odd, 1).astype(np.uint8)
    if (h_ratio, v_ratio) == (1, 2):
        top = (3 * a + _shift_rows(a, -1) + 1) >> 2
        bottom = (3 * a + _shift_rows(a, 1) + 2) >> 2
        return _interleave(top, bottom, 0).astype(np.uint8)
    if (h_ratio, v_ratio) == (2, 2):
        if width <= 2:
            return np.repeat(np.repeat(plane, 2, axis=0), 2, axis=1)
        rows = []
        for near in (3 * a + _shift_rows(a, -1), 3 * a + _shift_rows(a, 1)):
            even = (3 * near + _shift_cols(near, -1) + 8) >> 4
            odd = (3 * near + _shift_cols(near, 1) + 7) >> 4
            rows.append(_interleave(even, odd, 1))
        return _interleave(rows[0], rows[1], 0).astype(np.uint8)
    raise NotImplementedError(f"upsampling by ({h_ratio}, {v_ratio})")


_SCALEBITS = 16
_ONE_HALF = 1 << (_SCALEBITS - 1)


def _fix(x: float) -> int:
    return int(x * (1 << _SCALEBITS) + 0.5)


def _ycc_tables() -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """``jdcolor.c``'s build_ycc_rgb_table: Cr->R, Cb->B, Cr->G, Cb->G."""
    x = np.arange(256, dtype=np.int64) - 128
    cr_r = (_fix(1.40200) * x + _ONE_HALF) >> _SCALEBITS
    cb_b = (_fix(1.77200) * x + _ONE_HALF) >> _SCALEBITS
    cr_g = -_fix(0.71414) * x
    cb_g = -_fix(0.34414) * x + _ONE_HALF
    return cr_r, cb_b, cr_g, cb_g


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """(H, W) uint8 planes -> (H, W, 3) uint8 RGB, ``ycc_rgb_convert``."""
    y = y.astype(np.int64)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> _SCALEBITS)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------


class _Component:
    def __init__(self, cid: int, h: int, v: int, tq: int):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq
        self.quant: Optional[np.ndarray] = None  # latched at its first scan


def _u16(data: bytes, i: int) -> int:
    return (data[i] << 8) | data[i + 1]


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """Decode a JPEG file's bytes: (H, W) uint8 for one component, (H, W, 3)
    uint8 RGB for three. ``name`` labels the errors."""
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{name}: not a JPEG file (no SOI marker)")
    try:
        return _decode(data, name)
    except IndexError:
        raise ValueError(f"corrupt JPEG {name}: a segment is shorter than its fields") from None


def _decode(data: bytes, name: str) -> np.ndarray:
    qt: Dict[int, np.ndarray] = {}
    dht: Dict[Tuple[int, int], Tuple[bytes, bytes]] = {}
    comps: List[_Component] = []
    width = height = 0
    restart = 0
    saw_jfif = saw_adobe = False
    adobe_transform = 1
    sof = ""
    coef = None
    offsets: Dict[int, int] = {}
    grid: Dict[int, Tuple[int, int]] = {}
    i = 2
    n = len(data)
    while True:
        while i < n and data[i] != 0xFF:
            i += 1  # garbage between segments, which libjpeg skips with a warning
        while i < n and data[i] == 0xFF:
            i += 1
        if i >= n:
            raise ValueError(f"truncated JPEG {name}: no EOI marker")
        m = data[i]
        i += 1
        if m == 0xD9:  # EOI
            break
        if m == 0x01 or 0xD0 <= m <= 0xD7:
            continue  # parameterless markers
        if i + 2 > n:
            raise ValueError(f"truncated JPEG {name}: a segment header is cut")
        length = _u16(data, i)
        seg = data[i + 2:i + length]
        if len(seg) != length - 2:
            raise ValueError(f"truncated JPEG {name}: a segment is cut")
        i += length
        if m in _SOF_NAMES:
            sof = _SOF_NAMES[m]
            if m not in (0xC0, 0xC1):
                what = {0xC2: "progressive JPEG", 0xC3: "lossless JPEG"}.get(
                    m, "arithmetic-coded JPEG" if m >= 0xC9 else "hierarchical JPEG")
                raise _refuse(name, sof, what)
            precision, height, width, nf = seg[0], _u16(seg, 1), _u16(seg, 3), seg[5]
            if precision != 8:
                raise _refuse(name, sof, f"{precision}-bit JPEG")
            if nf not in (1, 3):
                raise _refuse(name, sof, f"a {nf}-component JPEG (CMYK/YCCK or other)")
            if height == 0 or width == 0:
                raise _refuse(name, sof, "a JPEG whose height comes in a DNL marker")
            comps = [_Component(seg[6 + 3 * c], seg[7 + 3 * c] >> 4, seg[7 + 3 * c] & 15,
                                seg[8 + 3 * c]) for c in range(nf)]
            hmax = max(c.h for c in comps)
            vmax = max(c.v for c in comps)
            for c in comps:
                if not (1 <= c.h <= 4 and 1 <= c.v <= 4) or hmax % c.h or vmax % c.v or (
                        hmax // c.h, vmax // c.v) not in ((1, 1), (2, 1), (1, 2), (2, 2)):
                    raise _refuse(name, sof, f"sampling factors {[(d.h, d.v) for d in comps]}")
            mcux = -(-width // (8 * hmax))
            mcuy = -(-height // (8 * vmax))
            total = 0
            for c in comps:
                grid[c.cid] = (mcuy * c.v, mcux * c.h)
                offsets[c.cid] = total
                total += mcuy * c.v * mcux * c.h * 64
            coef = np.zeros(total, np.int32)
        elif m == 0xC4:  # DHT
            j = 0
            while j < len(seg):
                tc, th = seg[j] >> 4, seg[j] & 15
                bits = bytes(seg[j + 1:j + 17])
                count = sum(bits)
                dht[(tc, th)] = (bits, bytes(seg[j + 17:j + 17 + count]))
                j += 17 + count
        elif m == 0xCC:
            raise _refuse(name, sof or "DAC", "arithmetic-coded JPEG")
        elif m == 0xDB:  # DQT
            j = 0
            while j < len(seg):
                pq, tq = seg[j] >> 4, seg[j] & 15
                size = 2 if pq else 1
                raw = np.frombuffer(bytes(seg[j + 1:j + 1 + 64 * size]),
                                    ">u2" if pq else np.uint8).astype(np.int64)
                table = np.zeros(64, np.int64)
                table[_ZIGZAG] = raw
                qt[tq] = table
                j += 1 + 64 * size
        elif m == 0xDD:  # DRI
            restart = _u16(seg, 0)
        elif m == 0xE0 and seg[:5] == b"JFIF\x00":
            saw_jfif = True
        elif m == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            saw_adobe = True
            adobe_transform = seg[11]
        elif m == 0xDA:  # SOS
            if coef is None:
                raise ValueError(f"corrupt JPEG {name}: a scan before the frame header")
            i = _decode_scan(data, i, seg, comps, dht, qt, restart, coef, offsets, grid,
                             width, height, name)
        # APPn, COM and other segments are skipped
    if coef is None:
        raise ValueError(f"corrupt JPEG {name}: no frame header")
    return _reconstruct(comps, coef, offsets, grid, width, height, saw_jfif, saw_adobe,
                        adobe_transform, name)


def _decode_scan(data: bytes, i: int, seg: bytes, comps: List[_Component], dht, qt,
                 restart: int, coef: np.ndarray, offsets, grid, width: int, height: int,
                 name: str) -> int:
    """Entropy-decode one sequential scan into ``coef``; returns the offset
    of the marker after it."""
    ns = seg[0]
    by_id = {c.cid: c for c in comps}
    scan = []
    for s in range(ns):
        cid, tables = seg[1 + 2 * s], seg[2 + 2 * s]
        if cid not in by_id:
            raise ValueError(f"corrupt JPEG {name}: a scan names an unknown component")
        scan.append((by_id[cid], tables >> 4, tables & 15))
    ss, se = seg[1 + 2 * ns], seg[2 + 2 * ns]
    if (ss, se) != (0, 63):
        raise ValueError(f"corrupt JPEG {name}: a sequential scan with spectral range "
                         f"{ss}..{se}")
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    dc_luts, ac_luts = [], []
    for c, td, ta in scan:
        if (0, td) not in dht or (1, ta) not in dht:
            raise ValueError(f"corrupt JPEG {name}: a scan uses an undefined Huffman table")
        dc_luts.append(_dc_lookup(*dht[(0, td)]))
        ac_luts.append(_ac_lookup(*dht[(1, ta)]))
        if c.quant is None:
            if c.tq not in qt:
                raise ValueError(f"corrupt JPEG {name}: undefined quantisation table {c.tq}")
            c.quant = qt[c.tq]
    if ns == 1:
        # non-interleaved: the component's own blocks, one a unit
        c = scan[0][0]
        bw = -(-(-(-width * c.h // hmax)) // 8)
        bh = -(-(-(-height * c.v // vmax)) // 8)
        rows, cols = np.meshgrid(np.arange(bh), np.arange(bw), indexing="ij")
        slot = np.zeros(bh * bw, np.int64)
        base = offsets[c.cid] + (rows.ravel() * grid[c.cid][1] + cols.ravel()) * 64
        per_unit = 1
    else:
        mcux = -(-width // (8 * hmax))
        mcuy = -(-height // (8 * vmax))
        slots, bases = [], []
        for k, (c, _, _) in enumerate(scan):
            for v in range(c.v):
                for h in range(c.h):
                    my, mx = np.meshgrid(np.arange(mcuy), np.arange(mcux), indexing="ij")
                    r, q = my.ravel() * c.v + v, mx.ravel() * c.h + h
                    slots.append(np.full(r.shape, k))
                    bases.append(offsets[c.cid] + (r * grid[c.cid][1] + q) * 64)
        # (units, blocks per unit) in the MCU's block order
        slot = np.stack(slots, axis=1).ravel()
        base = np.stack(bases, axis=1).ravel()
        per_unit = len(slots)
    units = len(base) // per_unit
    segments, end = _scan_segments(data, i, name)
    interval = restart if restart > 0 else units
    expected = -(-units // interval)
    if len(segments) < expected:
        raise ValueError(f"truncated JPEG {name}: {len(segments)} of {expected} restart "
                         f"intervals present")
    slot_l, base_l = slot.tolist(), base.tolist()
    out_idx: List[int] = []
    out_val: List[int] = []
    for j in range(expected):
        lo, hi = j * interval * per_unit, min((j + 1) * interval, units) * per_unit
        win = _bit_windows(segments[j])
        try:
            _decode_interval(win, 8 * len(segments[j]), slot_l[lo:hi], base_l[lo:hi],
                             dc_luts, ac_luts, len(scan), out_idx, out_val)
        except IndexError:
            raise ValueError(f"truncated JPEG {name}: the entropy-coded data ends inside "
                             f"a block") from None
    if out_idx:
        coef[np.asarray(out_idx, np.int64)] = np.asarray(out_val, np.int64).astype(np.int32)
    return end


def _reconstruct(comps: List[_Component], coef: np.ndarray, offsets, grid, width: int,
                 height: int, saw_jfif: bool, saw_adobe: bool, adobe_transform: int,
                 name: str) -> np.ndarray:
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    planes = []
    for c in comps:
        if c.quant is None:
            raise ValueError(f"corrupt JPEG {name}: component {c.cid} has no scan")
        bh, bw = grid[c.cid]
        n = bh * bw
        blocks = idct_islow(coef[offsets[c.cid]:offsets[c.cid] + n * 64].reshape(n, 64),
                            c.quant)
        plane = blocks.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(bh * 8, bw * 8)
        # the component's own size, the edge the upsampler replicates
        cw = -(-width * c.h // hmax)
        ch = -(-height * c.v // vmax)
        plane = upsample(plane[:ch, :cw], hmax // c.h, vmax // c.v)
        planes.append(plane[:height, :width])
    if len(planes) == 1:
        return np.ascontiguousarray(planes[0])
    if saw_jfif:
        ycc = True
    elif saw_adobe:
        ycc = adobe_transform != 0
    else:
        ycc = [c.cid for c in comps] != [82, 71, 66]  # 'R', 'G', 'B'
    if not ycc:
        return np.ascontiguousarray(np.stack(planes, axis=-1))
    return ycc_to_rgb(*planes)


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

# Annex K.1 tables, natural order
_LUMA_QUANT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], np.int64)
_CHROMA_QUANT = np.full(64, 99, np.int64)
_CHROMA_QUANT[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25, 32]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66, 99]

# Annex K.3 Huffman tables: (BITS, HUFFVAL)
_STD_HUFFMAN = {
    (0, 0): (bytes.fromhex("00010501010101010100000000000000"),
             bytes.fromhex("000102030405060708090a0b")),
    (0, 1): (bytes.fromhex("00030101010101010101010000000000"),
             bytes.fromhex("000102030405060708090a0b")),
    (1, 0): (bytes.fromhex("0002010303020403050504040000017d"), bytes.fromhex(
        "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
        "2433627282090a161718191a25262728292a3435363738393a43444546474849"
        "4a535455565758595a636465666768696a737475767778797a83848586878889"
        "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
        "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")),
    (1, 1): (bytes.fromhex("00020102040403040705040400010277"), bytes.fromhex(
        "000102031104052131061241510761711322328108144291a1b1c109233352f0"
        "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
        "494a535455565758595a636465666768696a737475767778797a828384858687"
        "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
        "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")),
}


def quant_tables(quality: int = 75) -> Tuple[np.ndarray, np.ndarray]:
    """libjpeg's ``jpeg_set_quality`` tables (natural order, baseline-clamped)."""
    if not 1 <= quality <= 100:
        raise ValueError(f"JPEG quality {quality} outside 1..100")
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return tuple(np.clip((t * scale + 50) // 100, 1, 255) for t in (_LUMA_QUANT, _CHROMA_QUANT))


def _code_table(bits: bytes, vals: bytes) -> Tuple[np.ndarray, np.ndarray]:
    """(code, length) indexed by symbol."""
    codes, lengths, syms = _canonical_codes(bits, vals)
    code_of = np.zeros(256, np.int64)
    len_of = np.zeros(256, np.int64)
    code_of[syms] = codes
    len_of[syms] = lengths
    return code_of, len_of


def _fdct_matrix() -> np.ndarray:
    k = np.arange(8)
    c = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) * 0.5
    c[0] /= np.sqrt(2.0)
    return c


def _blocks_of(plane: np.ndarray, bh: int, bw: int) -> np.ndarray:
    """(bh*8, bw*8) plane -> (bh*bw, 8, 8) blocks in raster order."""
    return plane.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)


def _pad_edge(plane: np.ndarray, h: int, w: int) -> np.ndarray:
    return np.pad(plane, ((0, h - plane.shape[0]), (0, w - plane.shape[1])), mode="edge")


def _bit_size(x: np.ndarray) -> np.ndarray:
    """Bits of |x| (the JPEG magnitude category), 0 for 0."""
    a = np.abs(x)
    size = np.zeros(a.shape, np.int64)
    nz = a > 0
    size[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    return size


def _huffman_stream(zz: np.ndarray, table: np.ndarray) -> bytes:
    """Entropy-code blocks in scan order: ``zz`` (n, 64) zig-zag quantised
    coefficients with the DC as a difference, ``table`` (n,) 0 luma / 1
    chroma. Returns the byte-stuffed entropy-coded segment."""
    n = zz.shape[0]
    dc_code = [_code_table(*_STD_HUFFMAN[(0, t)]) for t in (0, 1)]
    ac_code = [_code_table(*_STD_HUFFMAN[(1, t)]) for t in (0, 1)]
    keys, vals, nbits = [], [], []

    def emit(key, sym, tab, codes):
        code = np.where(tab == 0, codes[0][0][sym], codes[1][0][sym])
        length = np.where(tab == 0, codes[0][1][sym], codes[1][1][sym])
        keys.append(key)
        vals.append(code)
        nbits.append(length)

    # DC: category code, then the difference's low bits
    blk = np.arange(n, dtype=np.int64)
    dc = zz[:, 0]
    s = _bit_size(dc)
    emit(blk * 512, s, table, dc_code)
    keys.append(blk * 512 + 1)
    vals.append(np.where(dc < 0, dc + (1 << s) - 1, dc))
    nbits.append(s)
    # AC: (ZRL)* then (run, size) and the value's bits, EOB if the block ends early
    b, k = np.nonzero(zz[:, 1:])
    k = k + 1
    prev = np.zeros_like(k)
    follows = np.nonzero(b[1:] == b[:-1])[0] + 1  # not the first of its block
    prev[follows] = k[follows - 1]
    run = k - prev - 1
    zrl = run // 16
    rep = np.repeat(np.arange(len(b)), zrl)
    emit(b[rep] * 512 + 4 * k[rep], np.full(len(rep), 0xF0), table[b[rep]], ac_code)
    v = zz[b, k]
    s = _bit_size(v)
    emit(b * 512 + 4 * k + 1, (run % 16) * 16 + s, table[b], ac_code)
    keys.append(b * 512 + 4 * k + 2)
    vals.append(np.where(v < 0, v + (1 << s) - 1, v))
    nbits.append(s)
    last = np.zeros(n, np.int64)
    last[b] = k  # the last write per block is its largest k
    eob = np.nonzero(last < 63)[0]
    emit(eob * 512 + 256, np.zeros(len(eob), np.int64), table[eob], ac_code)

    key = np.concatenate(keys)
    val = np.concatenate(vals).astype(np.int64)
    nb = np.concatenate(nbits).astype(np.int64)
    order = np.argsort(key, kind="stable")
    val, nb = val[order], nb[order]
    # every field's bits, most significant first
    total = int(nb.sum())
    start = np.cumsum(nb) - nb
    field_bits = np.repeat(nb, nb)
    offset = np.arange(total, dtype=np.int64) - np.repeat(start, nb)
    bits = ((np.repeat(val, nb) >> (field_bits - 1 - offset)) & 1).astype(np.uint8)
    pad = (-total) % 8
    bits = np.concatenate([bits, np.ones(pad, np.uint8)])  # 1-bits fill the last byte
    out = np.packbits(bits)
    ff = np.nonzero(out == 0xFF)[0]
    return np.insert(out, ff + 1, 0).tobytes()


def _segment(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") + payload


def encode_jpeg(rgb: np.ndarray, quality: int = 75) -> bytes:
    """Baseline JFIF bytes of an (H, W, 3) uint8 RGB image, 4:2:0."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode_jpeg takes (H, W, 3) uint8 RGB, got {rgb.shape} {rgb.dtype}")
    height, width = rgb.shape[:2]
    if not (0 < height < 65536 and 0 < width < 65536):
        raise ValueError(f"JPEG size {width}x{height} outside 1..65535")
    f = rgb.astype(np.float64)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418687589 * g - 0.081312411 * b + 128.0
    mcux, mcuy = -(-width // 16), -(-height // 16)
    ch, cw = -(-height // 2), -(-width // 2)

    def down(p):  # 2x2 mean over the edge-padded plane
        p = _pad_edge(p, 2 * ch, 2 * cw)
        return p.reshape(ch, 2, cw, 2).mean(axis=(1, 3))

    lq, cq = quant_tables(quality)
    dct = _fdct_matrix()

    def quantise(plane, bh, bw, q):
        blocks = _blocks_of(_pad_edge(plane, bh * 8, bw * 8) - 128.0, bh, bw)
        coef = dct @ blocks @ dct.T
        return np.round(coef.reshape(-1, 64) / q).astype(np.int64)

    qy = quantise(y, 2 * mcuy, 2 * mcux, lq).reshape(mcuy, 2, mcux, 2, 64)
    qcb = quantise(down(cb), mcuy, mcux, cq).reshape(mcuy, mcux, 64)
    qcr = quantise(down(cr), mcuy, mcux, cq).reshape(mcuy, mcux, 64)
    # scan order: Y00 Y01 Y10 Y11 Cb Cr for each MCU
    mcu = np.concatenate([qy.transpose(0, 2, 1, 3, 4).reshape(mcuy, mcux, 4, 64),
                          qcb[:, :, None], qcr[:, :, None]], axis=2).reshape(-1, 6, 64)
    zz = mcu[:, :, _ZIGZAG]
    for first, last in ((0, 4), (4, 5), (5, 6)):  # DC differences per component
        dc = zz[:, first:last, 0].ravel()
        diff = np.diff(dc, prepend=0).reshape(-1, last - first)
        zz[:, first:last, 0] = diff
    table = np.tile(np.array([0, 0, 0, 0, 1, 1]), len(zz))
    data = _huffman_stream(zz.reshape(-1, 64), table)

    out = [b"\xff\xd8", _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    out.append(_segment(0xDB, b"\x00" + lq[_ZIGZAG].astype(np.uint8).tobytes()
                        + b"\x01" + cq[_ZIGZAG].astype(np.uint8).tobytes()))
    out.append(_segment(0xC0, bytes([8]) + height.to_bytes(2, "big") + width.to_bytes(2, "big")
                        + bytes([3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])))
    dht = b"".join(bytes([tc << 4 | th]) + bits + vals
                   for (tc, th), (bits, vals) in sorted(_STD_HUFFMAN.items()))
    out.append(_segment(0xC4, dht))
    out.append(_segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])))
    out.append(data)
    out.append(b"\xff\xd9")
    return b"".join(out)


def write_jpeg(path: str, rgb: np.ndarray, quality: int = 75) -> None:
    """Write ``encode_jpeg(rgb, quality)`` to ``path``."""
    with open(path, "wb") as f:
        f.write(encode_jpeg(rgb, quality))
