"""JPEG codec in numpy: every kind that cv2 and PIL read.

The decoder is held pixel for pixel to libjpeg-turbo's default decode,
which PIL and cv2 both run, so ``io/image.read_rgb`` gives the JAX
package's pixels (``maskclustering_tpu/io/image.py:49-56``, cv2) and
``read_rgb_pil``/``decode_rgb`` PIL's, without either library. It follows
libjpeg-turbo step by step:

- **sequential Huffman scans** (SOF0, SOF1) at 8 bits: one or more scans,
  interleaved or not, restart intervals (DRI, RSTn), byte stuffing and
  fill bytes. A table of all 65,536 16-bit peeks gives, in one lookup, the
  code length, the zero run and, where it fits in the peek, the
  coefficient itself;
- **progressive Huffman scans** (SOF2, ``jdphuff.c``) into the same
  coefficient store: DC first (interleaved or not) and DC refine; AC first
  bands of one component with end-of-band runs across blocks; AC refine
  bands (a correction bit for each coefficient already nonzero, new
  coefficients of magnitude ``1 << Al`` placed past ``r`` zero ones); a
  non-interleaved band covers the component's own blocks, not its MCUs;
  restart intervals in every scan;
- **arithmetic-coded scans** (SOF9, SOF10; ``io/jpeg_arith.py``,
  ``jdarith.c``), sequential and every progressive kind, DAC conditioning;
- **block smoothing** of a progressive file whose scans leave some of a
  component's coefficients 1-9 short (``io/jpeg_smooth.py``,
  ``jdcoefct.c``);
- **lossless** files (SOF3; ``io/jpeg_lossless.py``), which cv2's route
  refuses in greyscale as ``cv2.imread`` does;
- **dequantisation and the islow integer IDCT** (``jidctint.c``:
  ``CONST_BITS`` 13, ``PASS1_BITS`` 2), vectorised over all blocks of a
  component. The output saturates to 0..255 as the SIMD IDCT that PIL and
  cv2 run on x86 does, where the C code's range-limit table wraps. Blocks
  whose intermediates overflow 16 bits, which no encoder makes from 8-bit
  samples, are where the SIMD and C versions part further; the port
  follows neither there. A component that no scan reached decodes to 128;
- **upsampling** as ``jdsample.c`` chooses by each component's ratio to
  the largest factors (1 to 4, integral): h2v1 with its alternating +1/+2
  bias, h2v2 as the triangle filter (vertical first, then horizontal with
  +8/+7 and ``>> 4``), h1v2 with +1/+2, box replication for every other
  ratio, for a plane 2 or fewer samples wide in h2v1 and h2v2, and for
  lossless files. Edges replicate at the component's own width and height;
  partial MCUs are cropped last;
- **colour** with ``jdcolor.c``'s fixed-point tables (``SCALEBITS`` 16).
  Three components: JFIF means YCbCr, else the Adobe APP14 transform flag,
  else the component ids ('R', 'G', 'B' means RGB; unknown ids mean YCbCr,
  but RGB in a lossless file). Four components are CMYK, or YCCK under an
  Adobe transform other than 0 (``ycck_cmyk_convert``); each reader then
  turns CMYK into RGB its own way (:func:`cmyk_to_rgb_cv2`,
  :func:`cmyk_to_rgb_pil`).

What both libraries refuse raises ``NotImplementedError`` naming the file,
the SOF marker and the refusal: 12-bit and 16-bit samples, hierarchical
frames (SOF5-7, SOF13-15), arithmetic-coded lossless (SOF11), a height
left to a DNL marker, 2 or more than 4 components, a non-integral
upsampling ratio, a lossless file that needs a lossy colour conversion
(YCbCr, YCCK); and on cv2's route a lossless greyscale file. A truncated
or corrupt stream raises ``ValueError``. Neither is ever returned as a
wrong image.

The encoder writes the bytes of PIL's ``Image.save(format="JPEG",
quality=q)`` (libjpeg-turbo at PIL's defaults: baseline 4:2:0, islow DCT,
the standard Huffman tables, no optimisation, no restart markers, JFIF
density 1:1 without units) for every size and quality 1-100, following
libjpeg step by step in integer numpy:

- ``jcparam.c``'s quality-scaled Annex K tables, clamped to baseline;
- ``jccolor.c``'s fixed-point RGB to YCbCr (``SCALEBITS`` 16, the
  ``ONE_HALF - 1`` fudge on Cb and Cr);
- ``jcprepct.c``'s bottom-edge replication and ``jcsample.c``'s
  ``expand_right_edge`` and ``h2v2_downsample`` (a bias of 1, 2, 1, 2 along
  each output row);
- ``jfdctint.c``'s islow forward DCT, the mirror of ``idct_islow``;
- ``jcdctmgr.c``'s quantisation through ``compute_reciprocal``, magnitude
  first, sign after;
- ``jccoefct.c``'s dummy blocks past the right and bottom edges of a
  partial MCU (zero AC, a neighbour's DC);
- ``jcmarker.c``'s segments: SOI, APP0, one DQT a table, SOF0, one DHT a
  table (DC 0, AC 0, DC 1, AC 1), SOS, the entropy data, EOI.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import numpy as np

from maskclustering_tpu_torch.io import jpeg_arith, jpeg_lossless, jpeg_smooth

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


@functools.lru_cache(maxsize=32)
def _symbol_lookup(bits: bytes, vals: bytes) -> Tuple[List[int], List[int]]:
    """Per 16-bit peek: the code length (0 for no code) and the symbol."""
    length, sym = _peek_tables(bits, vals)
    return length.tolist(), sym.tolist()


# ---------------------------------------------------------------------------
# entropy decode
# ---------------------------------------------------------------------------


def _bit_windows(segment: bytes) -> List[int]:
    """Unstuffed entropy bytes -> the big-endian 32-bit word at every byte,
    with zero bytes past the end (libjpeg's fill past a marker)."""
    a = np.frombuffer(segment + bytes(8), np.uint8).astype(np.int64)
    return ((a[:-3] << 24) | (a[1:-2] << 16) | (a[2:-1] << 8) | a[3:]).tolist()


def _decode_interval(win: List[int], comp: List[int], base: List[int],
                     dc_luts: List, ac_luts: List, ncomp: int,
                     out_idx: List[int], out_val: List[int]) -> int:
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
    return pos


def _dc_first_interval(win: List[int], comp: List[int], base: List[int], dc_luts: List,
                       ncomp: int, al: int, out_idx: List[int], out_val: List[int]) -> int:
    """A progressive DC-first interval (``decode_mcu_DC_first``): each
    block's DC difference, predicted from its component's last, scaled by
    the point transform ``al``. Returns the bits read."""
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
        out_idx.append(b)
        out_val.append(v << al)
    return pos


def _dc_refine_interval(win: List[int], base: List[int], out_idx: List[int]) -> int:
    """A progressive DC-refine interval (``decode_mcu_DC_refine``): one bit
    a block; the blocks whose bit is 1 are kept."""
    for pos, b in enumerate(base):
        if (win[pos >> 3] >> (31 - (pos & 7))) & 1:
            out_idx.append(b)
    return len(base)


def _ac_first_interval(win: List[int], base: List[int], length: List[int], symbol: List[int],
                       ss: int, se: int, al: int, blocks: List[int]) -> int:
    """A progressive AC-first interval of one component
    (``decode_mcu_AC_first``): the band ``ss..se`` of each block, scaled
    by ``al``, with end-of-band runs across blocks. Returns the bits read."""
    zz = _ZIGZAG_PADDED
    pos = 0
    eobrun = 0
    for b in base:
        if eobrun:
            eobrun -= 1
            continue
        k = ss
        while k <= se:
            peek = (win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF
            n = length[peek]
            if not n:
                raise ValueError("corrupt JPEG data: bad Huffman code")
            pos += n
            r, s = symbol[peek] >> 4, symbol[peek] & 15
            if s:
                k += r
                bits = (win[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                pos += s
                blocks[b + zz[k]] = (bits if bits >> (s - 1) else bits - (1 << s) + 1) << al
            elif r == 15:  # ZRL
                k += 15
            else:  # EOBr: 2**r + r appended bits blocks end here
                eobrun = 1 << r
                if r:
                    eobrun += (win[pos >> 3] >> (32 - (pos & 7) - r)) & ((1 << r) - 1)
                    pos += r
                eobrun -= 1
                break
            k += 1
    return pos


def _ac_refine_interval(win: List[int], base: List[int], length: List[int], symbol: List[int],
                        ss: int, se: int, al: int, blocks: List[int]) -> int:
    """A progressive AC-refine interval of one component
    (``decode_mcu_AC_refine``): in the band ``ss..se``, a correction bit
    for each coefficient already nonzero (1 adds ``1 << al`` away from
    zero, once), and each new coefficient of magnitude ``1 << al`` placed
    after skipping ``r`` zero ones. Returns the bits read."""
    zz = _ZIGZAG_PADDED
    p1, m1 = 1 << al, -1 << al
    pos = 0
    eobrun = 0
    for b in base:
        k = ss
        if not eobrun:
            while k <= se:
                peek = (win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF
                n = length[peek]
                if not n:
                    raise ValueError("corrupt JPEG data: bad Huffman code")
                pos += n
                r, s = symbol[peek] >> 4, symbol[peek] & 15
                if s:  # a new coefficient: its sign bit
                    s = p1 if (win[pos >> 3] >> (31 - (pos & 7))) & 1 else m1
                    pos += 1
                elif r != 15:
                    eobrun = 1 << r
                    if r:
                        eobrun += (win[pos >> 3] >> (32 - (pos & 7) - r)) & ((1 << r) - 1)
                        pos += r
                    break
                while True:  # over nonzero coefficients and r zero ones
                    c = blocks[b + zz[k]]
                    if c:
                        if (win[pos >> 3] >> (31 - (pos & 7))) & 1 and not c & p1:
                            blocks[b + zz[k]] = c + p1 if c >= 0 else c + m1
                        pos += 1
                    else:
                        r -= 1
                        if r < 0:
                            break
                    k += 1
                    if k > se:
                        break
                if s:
                    blocks[b + zz[k]] = s
                k += 1
        if eobrun:
            while k <= se:
                c = blocks[b + zz[k]]
                if c:
                    if (win[pos >> 3] >> (31 - (pos & 7))) & 1 and not c & p1:
                        blocks[b + zz[k]] = c + p1 if c >= 0 else c + m1
                    pos += 1
                k += 1
            eobrun -= 1
    return pos


def _scan_segments(data: bytes, start: int, name: str,
                   spans: Optional[List[Tuple[int, int]]] = None) -> Tuple[List[bytes], int]:
    """Split a scan's entropy-coded data at its RSTn markers: the unstuffed
    bytes of each restart interval and the offset of the marker that ends
    the scan. ``spans`` gets each interval's (offset of its first byte,
    offset of the code of the marker after it)."""
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
        if spans is not None:
            spans.append((seg_start, k))
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


def upsample(plane: np.ndarray, h_ratio: int, v_ratio: int, fancy: bool = True) -> np.ndarray:
    """Upsample one component plane (cropped to its own width and height)
    by integral ratios as ``jdsample.c`` chooses: h2v1 and h2v2 fancy
    unless the plane is 2 or fewer samples wide, h1v2 fancy, every other
    ratio (and all of a lossless file, which libjpeg never upsamples
    fancily) by box replication (``int_upsample``)."""
    a = plane.astype(np.int64)
    width = a.shape[1]
    if (h_ratio, v_ratio) == (1, 1):
        return plane
    if (h_ratio, v_ratio) == (2, 1) and fancy and width > 2:
        even = (3 * a + _shift_cols(a, -1) + 1) >> 2
        odd = (3 * a + _shift_cols(a, 1) + 2) >> 2
        return _interleave(even, odd, 1).astype(np.uint8)
    if (h_ratio, v_ratio) == (1, 2) and fancy:
        top = (3 * a + _shift_rows(a, -1) + 1) >> 2
        bottom = (3 * a + _shift_rows(a, 1) + 2) >> 2
        return _interleave(top, bottom, 0).astype(np.uint8)
    if (h_ratio, v_ratio) == (2, 2) and fancy and width > 2:
        rows = []
        for near in (3 * a + _shift_rows(a, -1), 3 * a + _shift_rows(a, 1)):
            even = (3 * near + _shift_cols(near, -1) + 8) >> 4
            odd = (3 * near + _shift_cols(near, 1) + 7) >> 4
            rows.append(_interleave(even, odd, 1))
        return _interleave(rows[0], rows[1], 0).astype(np.uint8)
    return np.repeat(np.repeat(plane, v_ratio, axis=0), h_ratio, axis=1)


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


class _Frame:
    """A file's frame after its last scan: the coefficient store (or a
    lossless file's samples) and the markers that choose its colour space."""

    def __init__(self, marker: int, height: int, width: int, comps: List[_Component]):
        self.marker, self.height, self.width, self.comps = marker, height, width, comps
        self.hmax = max(c.h for c in comps)
        self.vmax = max(c.v for c in comps)
        self.progressive = marker in (0xC2, 0xCA)
        self.arithmetic = marker in (0xC9, 0xCA)
        self.lossless = marker == 0xC3
        mcux = -(-width // (8 * self.hmax))
        mcuy = -(-height // (8 * self.vmax))
        self.grid: Dict[int, Tuple[int, int]] = {}
        self.offsets: Dict[int, int] = {}
        total = 0
        for c in comps:
            self.grid[c.cid] = (mcuy * c.v, mcux * c.h)
            self.offsets[c.cid] = total
            total += mcuy * c.v * mcux * c.h * 64
        self.coef = np.zeros(0 if self.lossless else total, np.int32)
        # progressive: the point transform each coefficient of each
        # component has reached, -1 before its first scan (coef_bits)
        self.coef_bits = {c.cid: [-1] * 64 for c in comps} if self.progressive else None
        self.samples: Dict[int, np.ndarray] = {}  # lossless: each component's plane
        # arithmetic: each interval's first and last byte read (_last_read)
        self.arith_reads: List[Tuple[int, int]] = []
        self.saw_jfif = self.saw_adobe = False
        self.adobe_transform = 1

    def own_size(self, c: _Component) -> Tuple[int, int]:
        """The component's own (height, width) in samples."""
        return -(-self.height * c.v // self.vmax), -(-self.width * c.h // self.hmax)


def _u16(data: bytes, i: int) -> int:
    return (data[i] << 8) | data[i + 1]


def _refuse(name: str, what: str, who: str = "cv2 and PIL refuse it too") -> NotImplementedError:
    return NotImplementedError(f"{name}: {what}, which the port's JPEG codec does not decode: "
                               f"{who}")


def _read_sof(m: int, seg: bytes, name: str) -> _Frame:
    """A frame header (``get_sof``), refusing what libjpeg, and so cv2 and
    PIL, refuse."""
    sof = _SOF_NAMES[m]
    if m in (0xC5, 0xC6, 0xC7, 0xCD, 0xCE, 0xCF):
        raise _refuse(name, f"a hierarchical JPEG ({sof})")
    if m == 0xCB:
        raise _refuse(name, f"an arithmetic-coded lossless JPEG ({sof})")
    precision, height, width, nf = seg[0], _u16(seg, 1), _u16(seg, 3), seg[5]
    if precision != 8:
        raise _refuse(name, f"a {precision}-bit JPEG ({sof})",
                      "cv2 and PIL read 8-bit samples only")
    if height == 0 and width and nf:
        raise _refuse(name, f"a JPEG whose height comes in a DNL marker ({sof})")
    if not (width and nf):
        raise ValueError(f"corrupt JPEG {name}: an empty frame ({width} wide, {nf} components)")
    if nf not in (1, 3, 4):
        raise _refuse(name, f"a {nf}-component JPEG ({sof})")
    comps = [_Component(seg[6 + 3 * c], seg[7 + 3 * c] >> 4, seg[7 + 3 * c] & 15,
                        seg[8 + 3 * c]) for c in range(nf)]
    factors = [(c.h, c.v) for c in comps]
    if not all(1 <= h <= 4 and 1 <= v <= 4 for h, v in factors):
        raise ValueError(f"corrupt JPEG {name}: sampling factors {factors}")
    hmax = max(h for h, _ in factors)
    vmax = max(v for _, v in factors)
    if any(hmax % h or vmax % v for h, v in factors):
        # jdsample.c's JERR_FRACT_SAMPLE_NOTIMPL
        raise _refuse(name, f"sampling factors {factors}, a non-integral upsampling ratio "
                            f"({sof})")
    return _Frame(m, height, width, comps)


def _parse(data: bytes, name: str) -> _Frame:
    """Read every segment and scan up to EOI into a :class:`_Frame`."""
    qt: Dict[int, np.ndarray] = {}
    dht: Dict[Tuple[int, int], Tuple[bytes, bytes]] = {}
    cond = jpeg_arith.Conditioning()
    frame: Optional[_Frame] = None
    restart = 0
    saw_jfif = saw_adobe = False
    adobe_transform = 1
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
            if frame is not None:
                raise ValueError(f"corrupt JPEG {name}: a second frame header")
            frame = _read_sof(m, seg, name)
        elif m == 0xC4:  # DHT
            j = 0
            while j < len(seg):
                tc, th = seg[j] >> 4, seg[j] & 15
                bits = bytes(seg[j + 1:j + 17])
                count = sum(bits)
                dht[(tc, th)] = (bits, bytes(seg[j + 17:j + 17 + count]))
                j += 17 + count
        elif m == 0xCC:  # DAC
            cond.read_dac(seg)
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
            if frame is None:
                raise ValueError(f"corrupt JPEG {name}: a scan before the frame header")
            i = _decode_scan(data, i, seg, frame, dht, qt, restart, cond, name)
        # APPn, COM and other segments are skipped
    if frame is None:
        raise ValueError(f"corrupt JPEG {name}: no frame header")
    frame.saw_jfif, frame.saw_adobe, frame.adobe_transform = saw_jfif, saw_adobe, adobe_transform
    return frame


def _scan_layout(frame: _Frame, scan) -> Tuple[np.ndarray, np.ndarray, int]:
    """(slot, coefficient offset) of every block the scan codes, in order,
    and the blocks an MCU: a one-component scan covers the component's own
    blocks, one an MCU; an interleaved scan the MCU grid's."""
    if len(scan) == 1:
        c = scan[0][0]
        ch, cw = frame.own_size(c)
        bh, bw = -(-ch // 8), -(-cw // 8)
        rows, cols = np.meshgrid(np.arange(bh), np.arange(bw), indexing="ij")
        base = frame.offsets[c.cid] + (rows.ravel() * frame.grid[c.cid][1] + cols.ravel()) * 64
        return np.zeros(bh * bw, np.int64), base, 1
    mcux = -(-frame.width // (8 * frame.hmax))
    mcuy = -(-frame.height // (8 * frame.vmax))
    slots, bases = [], []
    my, mx = np.meshgrid(np.arange(mcuy), np.arange(mcux), indexing="ij")
    for k, (c, _, _) in enumerate(scan):
        for v in range(c.v):
            for h in range(c.h):
                r, q = my.ravel() * c.v + v, mx.ravel() * c.h + h
                slots.append(np.full(r.shape, k))
                bases.append(frame.offsets[c.cid] + (r * frame.grid[c.cid][1] + q) * 64)
    # (units, blocks per unit) in the MCU's block order
    return np.stack(slots, axis=1).ravel(), np.stack(bases, axis=1).ravel(), len(slots)


def _decode_scan(data: bytes, i: int, seg: bytes, frame: _Frame, dht, qt, restart: int,
                 cond, name: str) -> int:
    """Entropy-decode one scan into the frame; returns the offset of the
    marker after it. A progressive scan is one of its four kinds (DC first
    or refine, interleaved or not; AC first or refine of one component's
    band), and books the point transform its band reaches."""
    ns = seg[0]
    by_id = {c.cid: c for c in frame.comps}
    scan = []
    for s in range(ns):
        cid, tables = seg[1 + 2 * s], seg[2 + 2 * s]
        if cid not in by_id:
            raise ValueError(f"corrupt JPEG {name}: a scan names an unknown component")
        scan.append((by_id[cid], tables >> 4, tables & 15))
    ss, se, ah, al = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns] >> 4, seg[3 + 2 * ns] & 15
    if frame.lossless:
        return _decode_lossless_scan(data, i, frame, scan, dht, restart, ss, se, ah, al, name)
    coef_bits = frame.coef_bits
    if coef_bits is None:
        if (ss, se) != (0, 63):
            raise ValueError(f"corrupt JPEG {name}: a sequential scan with spectral range "
                             f"{ss}..{se}")
    elif (se != 0 if ss == 0 else (se < ss or se > 63 or ns != 1)) or (
            ah and al != ah - 1) or al > 13:
        # start_pass_phuff_decoder's and jdarith.c start_pass's JERR_BAD_PROGRESSION
        raise ValueError(f"corrupt JPEG {name}: a progressive scan of band {ss}..{se} "
                         f"with Ah {ah}, Al {al} over {ns} components")
    if ns > 1 and sum(c.h * c.v for c, _, _ in scan) > 10:
        raise ValueError(f"corrupt JPEG {name}: an MCU of "
                         f"{sum(c.h * c.v for c, _, _ in scan)} blocks (at most 10)")
    dc_luts, ac_luts = [], []
    for c, td, ta in scan:
        if not frame.arithmetic:
            if coef_bits is None:
                needs = [(0, td), (1, ta)]
            elif ss > 0:  # AC first or refine
                needs = [(1, ta)]
            else:  # DC first; a DC refinement reads raw bits
                needs = [] if ah else [(0, td)]
            if any(t not in dht for t in needs):
                raise ValueError(f"corrupt JPEG {name}: a scan uses an undefined Huffman "
                                 f"table")
            if (0, td) in needs:
                dc_luts.append(_dc_lookup(*dht[(0, td)]))
            if (1, ta) in needs:
                ac_luts.append(_ac_lookup(*dht[(1, ta)]) if coef_bits is None
                               else _symbol_lookup(*dht[(1, ta)]))
        if c.quant is None:
            if c.tq not in qt:
                raise ValueError(f"corrupt JPEG {name}: undefined quantisation table {c.tq}")
            c.quant = qt[c.tq]
        if coef_bits is not None:
            coef_bits[c.cid][ss:se + 1] = [al] * (se + 1 - ss)
    slot, base, per_unit = _scan_layout(frame, scan)
    units = len(base) // per_unit
    spans: List[Tuple[int, int]] = []
    segments, end = _scan_segments(data, i, name, spans)
    interval = restart if restart > 0 else units
    expected = -(-units // interval)
    if len(segments) < expected:
        raise ValueError(f"truncated JPEG {name}: {len(segments)} of {expected} restart "
                         f"intervals present")
    coef = frame.coef
    if coef_bits is not None and ss > 0:
        # an AC band of one component: its coefficients as a list, read
        # and written in place by the refinement
        cid = scan[0][0].cid
        lo = frame.offsets[cid]
        hi = lo + frame.grid[cid][0] * frame.grid[cid][1] * 64
        block_list = coef[lo:hi].tolist()
        base = base - lo
    slot_l, base_l = slot.tolist(), base.tolist()
    dc_tab = [td for _, td, _ in scan]
    ac_tab = [ta for _, _, ta in scan]
    out_idx: List[int] = []
    out_val: List[int] = []
    for j in range(expected):
        lo_u, hi_u = j * interval * per_unit, min((j + 1) * interval, units) * per_unit
        slots_j, bases_j = slot_l[lo_u:hi_u], base_l[lo_u:hi_u]
        if frame.arithmetic:
            # the decoder reads zeros past an interval's data, as libjpeg
            # does at a marker; a cut file has lost its markers instead
            seg_j = segments[j]
            if coef_bits is None:
                pos = jpeg_arith.sequential_interval(seg_j, slots_j, bases_j, dc_tab, ac_tab,
                                                     cond, _ZIGZAG_PADDED, out_idx, out_val)
            elif ss == 0 and not ah:
                pos = jpeg_arith.dc_first_interval(seg_j, slots_j, bases_j, dc_tab, cond, al,
                                                   out_idx, out_val)
            elif ss == 0:
                pos = jpeg_arith.dc_refine_interval(seg_j, bases_j, out_idx)
            elif not ah:
                pos = jpeg_arith.ac_first_interval(seg_j, bases_j, ss, se, al,
                                                   cond.kx[ac_tab[0]], _ZIGZAG_PADDED,
                                                   block_list)
            else:
                pos = jpeg_arith.ac_refine_interval(seg_j, bases_j, ss, se, al, _ZIGZAG_PADDED,
                                                    block_list)
            frame.arith_reads.append(_last_read(seg_j, spans[j], pos))
            continue
        win = _bit_windows(segments[j])
        try:
            if coef_bits is None:
                pos = _decode_interval(win, slots_j, bases_j, dc_luts, ac_luts, len(scan),
                                       out_idx, out_val)
            elif ss == 0 and not ah:
                pos = _dc_first_interval(win, slots_j, bases_j, dc_luts, len(scan), al,
                                         out_idx, out_val)
            elif ss == 0:
                pos = _dc_refine_interval(win, bases_j, out_idx)
            elif not ah:
                pos = _ac_first_interval(win, bases_j, *ac_luts[0], ss, se, al, block_list)
            else:
                pos = _ac_refine_interval(win, bases_j, *ac_luts[0], ss, se, al, block_list)
        except IndexError:
            pos = None
        if pos is None or pos > 8 * len(segments[j]):
            raise ValueError(f"truncated JPEG {name}: the entropy-coded data ends inside "
                             f"a block")
    if coef_bits is not None and ss > 0:
        coef[lo:hi] = np.asarray(block_list, np.int64).astype(np.int32)
    elif coef_bits is not None and ah:
        # DC refine: the bit Al of each block whose correction bit was 1
        coef[np.asarray(out_idx, np.int64)] |= np.int32(1 << al)
    elif out_idx:
        coef[np.asarray(out_idx, np.int64)] = np.asarray(out_val, np.int64).astype(np.int32)
    return end


def _last_read(segment: bytes, span: Tuple[int, int], pos: int) -> Tuple[int, int]:
    """(offset of an arithmetic interval's first byte, offset of the last
    byte libjpeg's decoder reads in it) after ``pos`` unstuffed bytes: a
    0xFF data byte is read with its stuffed zero, and a decoder that ran
    past the data read the marker's code."""
    start, code = span
    if pos > len(segment):
        return start, code
    u = pos - 1
    last = start + u + segment.count(b"\xff", 0, u)
    return start, last + (segment[u] == 0xFF)


def _decode_lossless_scan(data: bytes, i: int, frame: _Frame, scan, dht, restart: int,
                          psv: int, se: int, ah: int, pt: int, name: str) -> int:
    """A lossless scan (``jdlhuff.c``, ``jddiffct.c``): its components'
    samples, an MCU holding ``h`` x ``v`` of each (one sample of a
    one-component scan)."""
    if not 1 <= psv <= 7 or se or ah or pt >= 8:
        raise ValueError(f"corrupt JPEG {name}: a lossless scan with predictor {psv}, Se {se}, "
                         f"Ah {ah}, Pt {pt}")
    if any((0, td) not in dht for _, td, _ in scan):
        raise ValueError(f"corrupt JPEG {name}: a scan uses an undefined Huffman table")
    if len(scan) > 1 and sum(c.h * c.v for c, _, _ in scan) > 10:
        raise ValueError(f"corrupt JPEG {name}: an MCU of "
                         f"{sum(c.h * c.v for c, _, _ in scan)} samples (at most 10)")
    mcux = -(-frame.width // frame.hmax)
    mcuy = -(-frame.height // frame.vmax)
    slots, rows, cols, luts, shapes = [], [], [], [], []
    if len(scan) == 1:
        c, td, _ = scan[0]
        ch, cw = frame.own_size(c)
        r, q = np.meshgrid(np.arange(ch), np.arange(cw), indexing="ij")
        slot, row, col = np.zeros(ch * cw, np.int64), r.ravel(), q.ravel()
        per_unit, per_row, mcu_rows = 1, cw, ch
        luts = [_symbol_lookup(*dht[(0, td)])]
        shapes = [(ch, cw, ch, cw, 1, c.v)]
    else:
        my, mx = np.meshgrid(np.arange(mcuy), np.arange(mcux), indexing="ij")
        for k, (c, td, _) in enumerate(scan):
            for dv in range(c.v):
                for dh in range(c.h):
                    slots.append(np.full(my.size, k))
                    rows.append(my.ravel() * c.v + dv)
                    cols.append(mx.ravel() * c.h + dh)
                    luts.append(_symbol_lookup(*dht[(0, td)]))
            shapes.append((mcuy * c.v, mcux * c.h) + frame.own_size(c) + (c.v, c.v))
        slot, row, col = (np.stack(a, axis=1).ravel() for a in (slots, rows, cols))
        per_unit, per_row, mcu_rows = len(slots), mcux, mcuy
    if restart % per_row:
        raise ValueError(f"corrupt JPEG {name}: a lossless restart interval of {restart} MCUs "
                         f"is not a whole number of {per_row}-MCU rows")
    interval = restart if restart else per_row * mcu_rows
    segments, end = _scan_segments(data, i, name)
    expected = -(-mcu_rows * per_row // interval)
    if len(segments) < expected:
        raise ValueError(f"truncated JPEG {name}: {len(segments)} of {expected} restart "
                         f"intervals present")
    segments = segments[:expected]
    try:
        planes = jpeg_lossless.decode_scan([_bit_windows(s) for s in segments],
                                           [8 * len(s) for s in segments], luts, slot, row,
                                           col, per_unit, interval, shapes, psv, pt, 8,
                                           interval // per_row)
    except IndexError:
        raise ValueError(f"truncated JPEG {name}: the entropy-coded data ends inside a "
                         f"row") from None
    for (c, _, _), plane in zip(scan, planes):
        frame.samples[c.cid] = plane
    return end


def _color_space(frame: _Frame) -> str:
    """libjpeg's ``jpeg_color_space`` (``default_decompress_parms``): JFIF
    means YCbCr, else the Adobe transform, else the component ids (a
    lossless file's unknown ids mean RGB); four components are CMYK unless
    an Adobe transform other than 0 makes them YCCK."""
    if len(frame.comps) == 1:
        return "grey"
    if len(frame.comps) == 4:
        return "ycck" if frame.saw_adobe and frame.adobe_transform != 0 else "cmyk"
    if frame.saw_jfif:
        return "ycc"
    if frame.saw_adobe:
        return "rgb" if frame.adobe_transform == 0 else "ycc"
    ids = [c.cid for c in frame.comps]
    if ids == [82, 71, 66]:  # 'R', 'G', 'B'
        return "rgb"
    return "rgb" if frame.lossless else "ycc"


def _planes(frame: _Frame, name: str) -> List[np.ndarray]:
    """Each component's samples at the image's size: the IDCT of its
    coefficients (block-smoothed where libjpeg smooths) or its lossless
    samples, upsampled as ``jdsample.c`` chooses and cropped."""
    comps = frame.comps
    if frame.lossless and any(c.cid not in frame.samples for c in comps):
        raise ValueError(f"corrupt JPEG {name}: a component of a lossless file has no scan")
    # a component no scan reached keeps libjpeg's zeroed dequantisation
    # table, so its samples are all 128, and nothing is smoothed
    smooth = frame.progressive and all(c.quant is not None for c in comps) and \
        jpeg_smooth.smoothing_ok([c.quant for c in comps],
                                 [frame.coef_bits[c.cid][:10] for c in comps])
    imcu_rows = -(-frame.height // (8 * frame.vmax))
    planes = []
    for c in comps:
        ch, cw = frame.own_size(c)
        if frame.lossless:
            plane = frame.samples[c.cid]
        else:
            rows, cols = frame.grid[c.cid]
            lo = frame.offsets[c.cid]
            grid = frame.coef[lo:lo + rows * cols * 64].reshape(rows, cols, 64)
            if smooth:
                rows, cols = -(-ch // 8), -(-cw // 8)
                grid = jpeg_smooth.smooth_component(grid, rows, cols, c.v, imcu_rows, c.quant,
                                                    frame.coef_bits[c.cid][:10])
            blocks = idct_islow(grid.reshape(-1, 64),
                                c.quant if c.quant is not None else np.zeros(64, np.int64))
            plane = blocks.reshape(rows, cols, 8, 8).transpose(0, 2, 1, 3).reshape(rows * 8,
                                                                                    cols * 8)
        # the component's own size is the edge the upsampler replicates
        plane = upsample(plane[:ch, :cw], frame.hmax // c.h, frame.vmax // c.v,
                         fancy=not frame.lossless)
        planes.append(plane[:frame.height, :frame.width])
    return planes


def ycck_to_cmyk(y: np.ndarray, cb: np.ndarray, cr: np.ndarray, k: np.ndarray) -> np.ndarray:
    """``jdcolor.c``'s ``ycck_cmyk_convert``: the YCbCr to RGB tables, each
    result inverted and clamped; K unchanged. (H, W, 4) uint8."""
    y = y.astype(np.int64)
    c = 255 - (y + _CR_R[cr])
    m = 255 - (y + ((_CB_G[cb] + _CR_G[cr]) >> _SCALEBITS))
    yy = 255 - (y + _CB_B[cb])
    return np.stack([np.clip(c, 0, 255), np.clip(m, 0, 255), np.clip(yy, 0, 255),
                     k.astype(np.int64)], axis=-1).astype(np.uint8)


def cmyk_to_rgb_cv2(cmyk: np.ndarray) -> np.ndarray:
    """OpenCV's ``icvCvt_CMYK2BGR_8u_C4C3R`` on libjpeg's CMYK output, as
    RGB: each channel ``k - ((255 - x) * k >> 8)``."""
    p = cmyk.astype(np.int64)
    k = p[..., 3:]
    return (k - (((255 - p[..., :3]) * k) >> 8)).astype(np.uint8)


def cmyk_to_rgb_pil(cmyk: np.ndarray) -> np.ndarray:
    """PIL's route: the raw mode ``CMYK;I`` inverts libjpeg's output, then
    ``Convert.c``'s ``cmyk2rgb``: ``nk - MULDIV255(x, nk)``, ``nk = 255 - K``."""
    inv = 255 - cmyk.astype(np.int64)
    nk = 255 - inv[..., 3:]
    t = inv[..., :3] * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


# PIL's ImageFile.MAXBLOCK: the bytes it hands a decoder at a time
_PIL_BLOCK = 65536


def decode_jpeg(data: bytes, name: str = "<bytes>", reader: Optional[str] = None) -> np.ndarray:
    """Decode a JPEG file's bytes to libjpeg's default output: (H, W)
    uint8 for one component, (H, W, 3) RGB for three, (H, W, 4) CMYK for
    four. ``reader`` "cv2" or "pil" gives instead what that library's
    reader makes of the file before any grey-to-RGB step: a four-component
    file converted to RGB as each converts CMYK (they differ by up to 2),
    and on cv2's route, which asks libjpeg for BGR, a lossless greyscale
    file refused. ``name`` labels the errors."""
    if reader not in (None, "cv2", "pil"):
        raise ValueError(f"decode_jpeg: reader {reader!r} is not 'cv2' or 'pil'")
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{name}: not a JPEG file (no SOI marker)")
    try:
        frame = _parse(data, name)
    except IndexError:
        raise ValueError(f"corrupt JPEG {name}: a segment is shorter than its fields") from None
    space = _color_space(frame)
    sof = _SOF_NAMES[frame.marker]
    if reader == "pil" and frame.arithmetic:
        # PIL hands libjpeg the file in blocks of 65536 bytes, the next only
        # when libjpeg suspends for want of data; libjpeg's arithmetic
        # decoder cannot suspend (JERR_CANT_SUSPEND), so PIL fails on a
        # file whose arithmetic interval reads past the blocks it has
        for start, last in frame.arith_reads:
            if last >= -(-start // _PIL_BLOCK) * _PIL_BLOCK:
                raise _refuse(name, f"an arithmetic-coded JPEG ({sof}) whose interval from "
                                    f"byte {start} reads past byte "
                                    f"{-(-start // _PIL_BLOCK) * _PIL_BLOCK}",
                              "PIL gives libjpeg the file 65536 bytes at a time, and "
                              "libjpeg's arithmetic decoder cannot wait for more; cv2 reads it")
    if frame.lossless and space in ("ycc", "ycck"):
        # jdcolor.c allows no lossy colour conversion of a lossless file
        raise _refuse(name, f"a lossless {space.upper()} JPEG ({sof})")
    if frame.lossless and space == "grey" and reader == "cv2":
        raise _refuse(name, f"a lossless greyscale JPEG read as colour ({sof})",
                      "cv2.imread asks libjpeg for BGR, which it refuses for a lossless "
                      "greyscale file; PIL reads it")
    planes = _planes(frame, name)
    if space == "grey":
        return np.ascontiguousarray(planes[0])
    if space == "rgb":
        return np.ascontiguousarray(np.stack(planes, axis=-1))
    if space == "ycc":
        return ycc_to_rgb(*planes)
    cmyk = ycck_to_cmyk(*planes) if space == "ycck" else np.stack(planes, axis=-1)
    if reader == "cv2":
        return cmyk_to_rgb_cv2(cmyk)
    if reader == "pil":
        return cmyk_to_rgb_pil(cmyk)
    return np.ascontiguousarray(cmyk)


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


def _fdct_1d(x, first: bool):
    """One islow forward pass over the 8 inputs ``x[0..7]`` (int64 arrays),
    ``jfdctint.c`` term for term: the row pass (``first``) keeps
    ``PASS1_BITS`` of scale, the column pass removes it and leaves the
    result scaled up by 8."""
    tmp0, tmp7 = x[0] + x[7], x[0] - x[7]
    tmp1, tmp6 = x[1] + x[6], x[1] - x[6]
    tmp2, tmp5 = x[2] + x[5], x[2] - x[5]
    tmp3, tmp4 = x[3] + x[4], x[3] - x[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    s = _CONST_BITS - _PASS1_BITS if first else _CONST_BITS + _PASS1_BITS

    def descale(v, n):
        return (v + (1 << (n - 1))) >> n

    if first:
        o0, o4 = (tmp10 + tmp11) << _PASS1_BITS, (tmp10 - tmp11) << _PASS1_BITS
    else:
        o0, o4 = descale(tmp10 + tmp11, _PASS1_BITS), descale(tmp10 - tmp11, _PASS1_BITS)
    z1 = (tmp12 + tmp13) * _FIX_0_541196100
    o2 = descale(z1 + tmp13 * _FIX_0_765366865, s)
    o6 = descale(z1 - tmp12 * _FIX_1_847759065, s)

    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * _FIX_1_175875602
    tmp4 = tmp4 * _FIX_0_298631336
    tmp5 = tmp5 * _FIX_2_053119869
    tmp6 = tmp6 * _FIX_3_072711026
    tmp7 = tmp7 * _FIX_1_501321110
    z1 = z1 * -_FIX_0_899976223
    z2 = z2 * -_FIX_2_562915447
    z3 = z3 * -_FIX_1_961570560 + z5
    z4 = z4 * -_FIX_0_390180644 + z5
    o7 = descale(tmp4 + z1 + z3, s)
    o5 = descale(tmp5 + z2 + z4, s)
    o3 = descale(tmp6 + z2 + z3, s)
    o1 = descale(tmp7 + z1 + z4, s)
    return o0, o1, o2, o3, o4, o5, o6, o7


def fdct_islow(blocks: np.ndarray) -> np.ndarray:
    """(n, 8, 8) uint8 samples -> (n, 8, 8) int64 coefficients scaled up by
    8, ``jpeg_fdct_islow`` after ``convsamp``'s level shift."""
    x = blocks.astype(np.int64) - 128
    ws = np.stack(_fdct_1d([x[:, :, c] for c in range(8)], True), axis=2)  # rows
    return np.stack(_fdct_1d([ws[:, r, :] for r in range(8)], False), axis=1)  # columns


def _divisors(quant: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``jcdctmgr.c``'s ``compute_reciprocal`` for each islow divisor
    ``quant << 3``: (reciprocal, correction, shift) so that a magnitude
    quantises to ``((a + correction) * reciprocal) >> shift``."""
    recip, corr, shift = [], [], []
    for q in quant.tolist():
        d = int(q) << 3
        r = 16 + d.bit_length() - 1
        fq, fr = divmod(1 << r, d)
        c = d // 2
        if fr == 0:  # a power of two: the reciprocal would not fit 16 bits
            fq >>= 1
            r -= 1
        elif fr <= d // 2:
            c += 1
        else:
            fq += 1
        recip.append(fq)
        corr.append(c)
        shift.append(r)
    return tuple(np.asarray(v, np.int64) for v in (recip, corr, shift))


def _quantise(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """(n, 8, 8) islow coefficients -> (n, 64) natural-order quantised
    values: the magnitude divided through its reciprocal, then the sign."""
    recip, corr, shift = _divisors(quant)
    c = coef.reshape(-1, 64)
    mag = ((np.abs(c) + corr) * recip) >> shift
    return np.where(c < 0, -mag, mag)


def _rgb_ycc_tables() -> np.ndarray:
    """``jccolor.c``'s ``rgb_ycc_start``: (8, 256) int64 rows R->Y, G->Y,
    B->Y, R->Cb, G->Cb, B->Cb (= R->Cr), G->Cr, B->Cr."""
    i = np.arange(256, dtype=np.int64)
    cbcr_offset = 128 << _SCALEBITS
    return np.stack([
        _fix(0.29900) * i, _fix(0.58700) * i, _fix(0.11400) * i + _ONE_HALF,
        -_fix(0.16874) * i, -_fix(0.33126) * i,
        # the rounding fudge 0.5 - epsilon keeps the largest output at 255
        _fix(0.50000) * i + cbcr_offset + _ONE_HALF - 1,
        -_fix(0.41869) * i, -_fix(0.08131) * i])


_RGB_YCC = _rgb_ycc_tables()


def rgb_to_ycc(rgb: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(H, W, 3) uint8 RGB -> three (H, W) int64 planes, ``rgb_ycc_convert``."""
    r, g, b = (rgb[..., k].astype(np.int64) for k in range(3))
    t = _RGB_YCC
    y = (t[0][r] + t[1][g] + t[2][b]) >> _SCALEBITS
    cb = (t[3][r] + t[4][g] + t[5][b]) >> _SCALEBITS
    cr = (t[5][r] + t[6][g] + t[7][b]) >> _SCALEBITS
    return y, cb, cr


def _pad_edge(plane: np.ndarray, h: int, w: int) -> np.ndarray:
    """Replicate the last row and column out to (h, w): ``jcprepct.c``'s
    ``expand_bottom_edge`` and ``jcsample.c``'s ``expand_right_edge``."""
    return np.pad(plane, ((0, h - plane.shape[0]), (0, w - plane.shape[1])), mode="edge")


def downsample_h2v2(plane: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """``jcsample.c``'s ``h2v2_downsample`` of a full-size chroma plane to
    (out_h, out_w): the plane edge-replicated to twice that, each 2x2 sum
    plus a bias of 1, 2, 1, 2, ... along every output row, shifted by 2."""
    p = _pad_edge(plane, 2 * out_h, 2 * out_w)
    s = p.reshape(out_h, 2, out_w, 2).sum(axis=(1, 3))
    bias = 1 + (np.arange(out_w) & 1)
    return (s + bias) >> 2


def _blocks_of(plane: np.ndarray, bh: int, bw: int) -> np.ndarray:
    """(bh*8, bw*8) plane -> (bh*bw, 8, 8) blocks in raster order."""
    return plane.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)


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
    """Baseline JFIF bytes of an (H, W, 3) uint8 RGB image, 4:2:0: the
    bytes PIL's ``Image.save(format="JPEG", quality=quality)`` writes."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode_jpeg takes (H, W, 3) uint8 RGB, got {rgb.shape} {rgb.dtype}")
    height, width = rgb.shape[:2]
    if not (0 < height < 65536 and 0 < width < 65536):
        raise ValueError(f"JPEG size {width}x{height} outside 1..65535")
    lq, cq = quant_tables(quality)
    y, cb, cr = rgb_to_ycc(rgb)
    mcuy, mcux = -(-height // 16), -(-width // 16)
    hb, wb = -(-height // 8), -(-width // 8)  # luma blocks that hold image rows / columns

    # luma: edge-replicated to whole blocks; the MCU grid's blocks past
    # them are jccoefct.c's dummies, all zero but for a copied DC
    qy = _quantise(fdct_islow(_blocks_of(_pad_edge(y, 8 * hb, 8 * wb), hb, wb)), lq)
    grid = np.zeros((2 * mcuy, 2 * mcux, 64), np.int64)
    grid[:hb, :wb] = qy.reshape(hb, wb, 64)
    if wb % 2:  # right dummies take the DC of the block on their left
        grid[:hb, wb, 0] = grid[:hb, wb - 1, 0]
    if hb % 2:  # a bottom row of dummies takes its MCU's top-right DC
        grid[hb, :, 0] = np.repeat(grid[hb - 1, 1::2, 0], 2)
    qy = grid.reshape(mcuy, 2, mcux, 2, 64)

    # chroma: the full-size plane's rows made even, downsampled to the MCU
    # grid's width, then its last row replicated to the grid's height
    ch = -(-height // 2)

    def chroma(plane):
        small = downsample_h2v2(plane, ch, 8 * mcux)
        return _quantise(fdct_islow(_blocks_of(_pad_edge(small, 8 * mcuy, 8 * mcux),
                                               mcuy, mcux)), cq).reshape(mcuy, mcux, 64)

    qcb, qcr = chroma(cb), chroma(cr)
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

    # jcmarker.c's order: a DQT a table, a DHT a table as the scan first
    # needs it (DC 0, AC 0, DC 1, AC 1)
    out = [b"\xff\xd8", _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for tq, q in enumerate((lq, cq)):
        out.append(_segment(0xDB, bytes([tq]) + q[_ZIGZAG].astype(np.uint8).tobytes()))
    out.append(_segment(0xC0, bytes([8]) + height.to_bytes(2, "big") + width.to_bytes(2, "big")
                        + bytes([3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])))
    for th in (0, 1):
        for tc in (0, 1):
            bits, vals = _STD_HUFFMAN[(tc, th)]
            out.append(_segment(0xC4, bytes([tc << 4 | th]) + bits + vals))
    out.append(_segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])))
    out.append(data)
    out.append(b"\xff\xd9")
    return b"".join(out)


def write_jpeg(path: str, rgb: np.ndarray, quality: int = 75) -> None:
    """Write ``encode_jpeg(rgb, quality)`` to ``path``."""
    with open(path, "wb") as f:
        f.write(encode_jpeg(rgb, quality))
