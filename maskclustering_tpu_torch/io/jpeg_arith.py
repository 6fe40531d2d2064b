"""Arithmetic entropy decoding of JPEG scans (SOF9, SOF10): ``jdarith.c``.

The QM decoder (``arith_decode``) with the probability estimation table
of ``jaricom.c`` (T.81 Table D.2), and the four progressive scan kinds and
the sequential scan on its statistics model:

- DC: the difference's zero, sign and magnitude decisions in bins chosen
  by the previous difference's class (zero, small or large under DAC's L
  and U), the magnitude categories from bin 20 and their bits 14 bins on;
- AC: an end-of-block decision and a zero run in three bins a zig-zag
  position, the sign at the fixed 0.5 bin, magnitudes from bin 189 or 217
  by DAC's Kx;
- refinements: a DC bit a block at the fixed bin; an AC refinement's
  end-of-block decisions past the last coefficient the earlier scans made
  nonzero, a correction bit for each such coefficient, new ones of
  magnitude ``1 << Al``.

Statistics belong to a table number (components of a scan that share a
table share them) and start from zero at each scan and restart marker.
Past the end of an interval's data the decoder reads zeros, as libjpeg
does once it meets a marker. A decision sequence that overflows a
magnitude or runs past the band, which libjpeg only warns of, raises
``ValueError``.
"""

from __future__ import annotations

from typing import List, Sequence

# T.81 Table D.2 (jaricom.c): (Qe, next index after an LPS with the MPS
# switch in bit 7, next index after an MPS); entry 113 is the fixed 0.5
# estimate of the sign and refinement bits
_TABLE = (
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080b, 18, 4, 0),
    (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0), (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0),
    (0x0036, 30, 9, 0), (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1), (0x3f25, 36, 16, 0),
    (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0), (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0cef, 43, 21, 0), (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01b1, 54, 28, 0),
    (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0), (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0),
    (0x0068, 62, 33, 0), (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0), (0x2ef1, 67, 40, 0),
    (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0), (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0),
    (0x1177, 73, 45, 0), (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0), (0x04de, 50, 52, 0),
    (0x040f, 50, 53, 0), (0x0363, 51, 54, 0), (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0),
    (0x01f8, 54, 57, 0), (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0), (0x008f, 61, 32, 0),
    (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0), (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0),
    (0x2fe8, 83, 69, 0), (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0), (0x119c, 74, 76, 0),
    (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0), (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0), (0x2516, 86, 71, 0),
    (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0), (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0),
    (0x3824, 99, 93, 0), (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0), (0x3c3d, 104, 100, 0),
    (0x375e, 99, 93, 0), (0x5231, 105, 102, 0), (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0),
    (0x415e, 103, 99, 0), (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1), (0x5522, 112, 109, 0),
    (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0))

# (Qe, Next_Index_LPS | Switch_MPS << 7, Next_Index_MPS) by state index
QE_TABLE = tuple((qe, nl | switch << 7, nm) for qe, nl, nm, switch in _TABLE)
_QE = [t[0] for t in QE_TABLE]
_NL = [t[1] for t in QE_TABLE]
_NM = [t[2] for t in QE_TABLE]

_DC_BINS, _AC_BINS = 64, 256


class ArithDecoder:
    """``arith_decode`` over one interval's unstuffed bytes, zeros past them."""

    __slots__ = ("data", "end", "pos", "c", "a", "ct")

    def __init__(self, data: bytes):
        self.data = data
        self.end = len(data)
        self.pos = 0
        self.c = 0
        self.a = 0
        self.ct = -16  # two bytes fill C before the first decision

    def decode(self, st: bytearray, i: int) -> int:
        """One binary decision in bin ``st[i]``, which it updates."""
        a = self.a
        if a < 0x8000:
            c, ct = self.c, self.ct
            while a < 0x8000:
                ct -= 1
                if ct < 0:
                    p = self.pos
                    c = (c << 8) | (self.data[p] if p < self.end else 0)
                    self.pos = p + 1
                    ct += 8
                    if ct < 0:
                        ct += 1
                        if ct == 0:
                            a = 0x8000
                a <<= 1
            self.c, self.ct = c, ct
        sv = st[i]
        s = sv & 0x7F
        qe = _QE[s]
        a -= qe
        temp = a << self.ct
        if self.c >= temp:
            self.c -= temp
            if a < qe:
                st[i] = (sv & 0x80) ^ _NM[s]
            else:
                st[i] = (sv & 0x80) ^ _NL[s]
                sv ^= 0x80
            self.a = qe
        else:
            if a < 0x8000:
                if a < qe:
                    st[i] = (sv & 0x80) ^ _NL[s]
                    sv ^= 0x80
                else:
                    st[i] = (sv & 0x80) ^ _NM[s]
            self.a = a
        return sv >> 7


def _corrupt(what: str) -> ValueError:
    return ValueError(f"corrupt JPEG data: an arithmetic-coded {what}")


def _bits(d: ArithDecoder, stats: bytearray, st: int, m: int) -> int:
    """Figure F.24: the bits below the top bit ``m`` of a magnitude, 14
    bins past its last category bin ``st``."""
    v = m
    st += 14
    while m > 1:
        m >>= 1
        if d.decode(stats, st):
            v |= m
    return v


def _dc_diff(d: ArithDecoder, stats: bytearray, ctx: List[int], slot: int, lo: int,
             hi: int) -> int:
    """Figures F.19-F.24 and F.1.4.4.1.2: the DC difference of the scan's
    component ``slot``, which sets that component's conditioning for the
    next one (``lo``, ``hi``: DAC's ``(1 << L) >> 1`` and ``(1 << U) >> 1``)."""
    st = ctx[slot]
    if not d.decode(stats, st):
        ctx[slot] = 0
        return 0
    sign = d.decode(stats, st + 1)
    st += 2 + sign
    m = d.decode(stats, st)
    if m:
        st = 20
        while d.decode(stats, st):
            m <<= 1
            if m == 0x8000:
                raise _corrupt("DC magnitude overflows 15 bits")
            st += 1
    if m < lo:
        ctx[slot] = 0
    elif m > hi:
        ctx[slot] = 12 + 4 * sign
    else:
        ctx[slot] = 4 + 4 * sign
    v = _bits(d, stats, st, m) + 1
    return -v if sign else v


def _ac_value(d: ArithDecoder, stats: bytearray, fixed: bytearray, st: int, k: int,
              kx: int) -> int:
    """Figures F.21-F.24 for the AC coefficient at zig-zag position ``k``
    whose zero-run decision was made in bin ``st + 1``."""
    sign = d.decode(fixed, 0)
    st += 2
    m = d.decode(stats, st)
    if m and d.decode(stats, st):
        m = 2
        st = 189 if k <= kx else 217
        while d.decode(stats, st):
            m <<= 1
            if m == 0x8000:
                raise _corrupt("AC magnitude overflows 15 bits")
            st += 1
    v = _bits(d, stats, st, m) + 1
    return -v if sign else v


def _int16(v: int) -> int:
    """A JCOEF: the low 16 bits, signed."""
    return ((v + 0x8000) & 0xFFFF) - 0x8000


class Conditioning:
    """DAC's conditioning of each table, libjpeg's defaults (L 0, U 1,
    Kx 5) until a DAC segment sets them."""

    def __init__(self):
        self.dc = {t: (0, 1) for t in range(16)}
        self.kx = {t: 5 for t in range(16)}

    def read_dac(self, seg: bytes) -> None:
        """``get_dac``: (Tc << 4 | Tb, value) pairs."""
        for j in range(0, len(seg) - 1, 2):
            index, val = seg[j], seg[j + 1]
            if index >= 32:
                raise ValueError(f"corrupt JPEG: DAC table index {index}")
            if index >= 16:
                self.kx[index - 16] = val
            else:
                lo, hi = val & 15, val >> 4
                if lo > hi:
                    raise ValueError(f"corrupt JPEG: DAC value {val:#x} has L above U")
                self.dc[index] = (lo, hi)

    def dc_bounds(self, t: int):
        lo, hi = self.dc[t]
        return (1 << lo) >> 1, (1 << hi) >> 1


def sequential_interval(data: bytes, slots: Sequence[int], bases: Sequence[int],
                        dc_tab: Sequence[int], ac_tab: Sequence[int], cond: Conditioning,
                        zz: Sequence[int], out_idx: List[int], out_val: List[int]) -> int:
    """``decode_mcu`` over one restart interval: block j of component slot
    ``slots[j]`` at coefficient offset ``bases[j]``; every coefficient is
    appended as (offset + natural index, value). Each interval function
    returns the bytes its decoder read (zeros past the data included)."""
    d = ArithDecoder(data)
    dc_stats = {t: bytearray(_DC_BINS) for t in set(dc_tab)}
    ac_stats = {t: bytearray(_AC_BINS) for t in set(ac_tab)}
    fixed = bytearray([113])
    bounds = [cond.dc_bounds(t) for t in dc_tab]
    last = [0] * len(dc_tab)
    ctx = [0] * len(dc_tab)
    decode = d.decode
    for slot, b in zip(slots, bases):
        lo, hi = bounds[slot]
        diff = _dc_diff(d, dc_stats[dc_tab[slot]], ctx, slot, lo, hi)
        last[slot] = (last[slot] + diff) & 0xFFFF
        out_idx.append(b)
        out_val.append(_int16(last[slot]))
        stats = ac_stats[ac_tab[slot]]
        kx = cond.kx[ac_tab[slot]]
        k = 1
        while k <= 63:
            st = 3 * (k - 1)
            if decode(stats, st):
                break
            while not decode(stats, st + 1):
                st += 3
                k += 1
                if k > 63:
                    raise _corrupt("block runs past coefficient 63")
            out_idx.append(b + zz[k])
            out_val.append(_int16(_ac_value(d, stats, fixed, st, k, kx)))
            k += 1
    return d.pos


def dc_first_interval(data: bytes, slots: Sequence[int], bases: Sequence[int],
                      dc_tab: Sequence[int], cond: Conditioning, al: int,
                      out_idx: List[int], out_val: List[int]) -> int:
    """``decode_mcu_DC_first``: each block's DC, scaled by ``al``."""
    d = ArithDecoder(data)
    dc_stats = {t: bytearray(_DC_BINS) for t in set(dc_tab)}
    bounds = [cond.dc_bounds(t) for t in dc_tab]
    last = [0] * len(dc_tab)
    ctx = [0] * len(dc_tab)
    for slot, b in zip(slots, bases):
        lo, hi = bounds[slot]
        last[slot] = (last[slot] + _dc_diff(d, dc_stats[dc_tab[slot]], ctx, slot, lo,
                                            hi)) & 0xFFFF
        out_idx.append(b)
        out_val.append(_int16(last[slot] << al))
    return d.pos


def dc_refine_interval(data: bytes, bases: Sequence[int], out_idx: List[int]) -> int:
    """``decode_mcu_DC_refine``: one bit a block at the fixed bin; the
    blocks whose bit is 1 are appended."""
    d = ArithDecoder(data)
    fixed = bytearray([113])
    for b in bases:
        if d.decode(fixed, 0):
            out_idx.append(b)
    return d.pos


def ac_first_interval(data: bytes, bases: Sequence[int], ss: int, se: int, al: int,
                      kx: int, zz: Sequence[int], blocks: List[int]) -> int:
    """``decode_mcu_AC_first``: the band ``ss..se`` of each block of one
    component, scaled by ``al``, written into ``blocks``."""
    d = ArithDecoder(data)
    decode = d.decode
    stats = bytearray(_AC_BINS)
    fixed = bytearray([113])
    for b in bases:
        k = ss
        while k <= se:
            st = 3 * (k - 1)
            if decode(stats, st):
                break
            while not decode(stats, st + 1):
                st += 3
                k += 1
                if k > se:
                    raise _corrupt("band runs past its end")
            blocks[b + zz[k]] = _int16(_ac_value(d, stats, fixed, st, k, kx) << al)
            k += 1
    return d.pos


def ac_refine_interval(data: bytes, bases: Sequence[int], ss: int, se: int, al: int,
                       zz: Sequence[int], blocks: List[int]) -> int:
    """``decode_mcu_AC_refine``: end-of-block decisions only past the last
    coefficient already nonzero; a correction bit for each nonzero one (1
    adds ``1 << al`` away from zero); new coefficients of magnitude
    ``1 << al``."""
    d = ArithDecoder(data)
    decode = d.decode
    stats = bytearray(_AC_BINS)
    fixed = bytearray([113])
    p1, m1 = 1 << al, -1 << al
    for b in bases:
        kex = se
        while kex > 0 and not blocks[b + zz[kex]]:
            kex -= 1
        k = ss
        while k <= se:
            st = 3 * (k - 1)
            if k > kex and decode(stats, st):
                break
            while True:
                idx = b + zz[k]
                c = blocks[idx]
                if c:
                    if decode(stats, st + 2):
                        blocks[idx] = c + (m1 if c < 0 else p1)
                    break
                if decode(stats, st + 1):
                    blocks[idx] = m1 if decode(fixed, 0) else p1
                    break
                st += 3
                k += 1
                if k > se:
                    raise _corrupt("band runs past its end")
            k += 1
    return d.pos
