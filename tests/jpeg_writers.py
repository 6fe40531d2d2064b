"""Numpy writers of the JPEG kinds that the port's decoder reads or refuses.

``tests/test_torch_jpeg_*.py`` hold the port's decoder to cv2 and PIL on
these files; ``chip_smoke.py`` phase 23 makes the same files on a machine
without either library and holds the port to goldens recorded from them
(``tests/jpeg_kinds/goldens.json``). Nothing here imports PIL or cv2
but :func:`record_goldens`.

- :class:`Frame`: quantised coefficients of 1 to 4 components at any
  sampling factors, on their MCU grid; :func:`frame_from_planes` makes one
  from component planes with the port's encoder steps, :func:`read_frame`
  from a Huffman file's bytes (the port's own entropy decoder);
- :func:`write_huffman`: a sequential Huffman file (SOF0, or SOF1 with
  12-bit samples and tables built for them), restart intervals optional;
- :func:`write_arith`: the same coefficients arithmetic-coded on
  ``jcarith.c``'s model, sequential (SOF9) or progressive (SOF10) with any
  scan script, DAC conditioning and restart intervals optional.
  :func:`transcode_arith` is ``jpegtran -arithmetic``: a Huffman file's
  coefficients, segments and scan script, arithmetic-coded;
- :func:`write_lossless`: lossless Huffman (SOF3), predictors 1-7, a point
  transform, restart intervals, 1 or 3 components;
- :func:`cmyk_to_ycck`, :func:`exif_orientation`, :func:`scan_starts`,
  :func:`cut_after`, :func:`subsampled`;
- :func:`fixtures`: every kind as one small file each, and
  :func:`record_goldens` their hashes under cv2 and PIL::

      python tests/jpeg_writers.py  # rewrites tests/jpeg_kinds/goldens.json
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import sys
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from maskclustering_tpu_torch.io import jpeg  # noqa: E402
from maskclustering_tpu_torch.io.jpeg_arith import QE_TABLE  # noqa: E402

JFIF = jpeg._segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
ZIGZAG = jpeg._ZIGZAG


def adobe(transform: int) -> bytes:
    """An Adobe APP14 segment with the given colour transform."""
    return jpeg._segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([transform]))


def photo(h: int, w: int, seed: int, noise: float = 20.0, channels: int = 3) -> np.ndarray:
    """A smooth gradient under seeded noise (dense AC coefficients)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1), (x + 2 * y) * 3 % 256,
                     (x * 7 + y * 5) % 256][:channels], axis=-1)
    return np.clip(base + rng.normal(0.0, noise, (h, w, channels)), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# coefficient frames
# ---------------------------------------------------------------------------


@dataclass
class Frame:
    """A frame's quantised coefficients: ``coef[c]`` is component c's
    (rows, cols, 64) natural-order grid over the MCU grid (dummy blocks
    past the image included)."""

    height: int
    width: int
    comps: List[Tuple[int, int, int, int]]  # (id, h, v, quant table)
    quant: Dict[int, np.ndarray]  # natural order
    coef: List[np.ndarray]
    head: bytes = b""  # the segments between SOI and the tables (APPn)
    precision: int = 8
    scans: List[Tuple[Tuple[int, ...], int, int, int, int]] = field(default_factory=list)

    @property
    def hmax(self) -> int:
        return max(c[1] for c in self.comps)

    @property
    def vmax(self) -> int:
        return max(c[2] for c in self.comps)

    @property
    def mcus(self) -> Tuple[int, int]:
        return -(-self.height // (8 * self.vmax)), -(-self.width // (8 * self.hmax))

    def own_blocks(self, ci: int) -> Tuple[int, int]:
        """Component ci's blocks that hold its samples (rows, cols)."""
        _, h, v, _ = self.comps[ci]
        return (-(-(-(-self.height * v // self.vmax)) // 8),
                -(-(-(-self.width * h // self.hmax)) // 8))


def frame_from_planes(planes: Sequence[np.ndarray], factors: Sequence[Tuple[int, int]],
                      quant: Sequence[np.ndarray], ids: Optional[Sequence[int]] = None,
                      head: bytes = JFIF, size: Optional[Tuple[int, int]] = None) -> Frame:
    """Quantised coefficients of uint8 component planes, each at least its
    own size (``ceil(W * h / hmax)`` by ``ceil(H * v / vmax)``; the image
    is ``size`` (H, W), by default the first plane's), with table
    ``quant[c]``: the port's islow FDCT and quantisation, the MCU grid
    edge-replicated."""
    height, width = size if size is not None else planes[0].shape
    hmax = max(h for h, _ in factors)
    vmax = max(v for _, v in factors)
    mcuy, mcux = -(-height // (8 * vmax)), -(-width // (8 * hmax))
    ids = list(ids) if ids is not None else list(range(1, len(planes) + 1))
    comps, tables, coef = [], {}, []
    for c, (plane, (h, v)) in enumerate(zip(planes, factors)):
        ch, cw = -(-height * v // vmax), -(-width * h // hmax)
        p = np.asarray(plane)[:ch, :cw].astype(np.int64)
        p = np.pad(p, ((0, mcuy * v * 8 - ch), (0, mcux * h * 8 - cw)), mode="edge")
        rows, cols = mcuy * v, mcux * h
        blocks = p.reshape(rows, 8, cols, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)
        q = np.asarray(quant[c], np.int64)
        tq = next((k for k, t in tables.items() if np.array_equal(t, q)), len(tables))
        tables[tq] = q
        coef.append(jpeg._quantise(jpeg.fdct_islow(blocks), q).reshape(rows, cols, 64))
        comps.append((ids[c], h, v, tq))
    return Frame(height, width, comps, tables, coef, head)


def read_frame(data: bytes) -> Frame:
    """A Huffman file's coefficients (through the port's entropy decoder),
    its APPn segments and its scan script."""
    parsed = jpeg._parse(data, "<writer>")
    coef = []
    for c in parsed.comps:
        rows, cols = parsed.grid[c.cid]
        lo = parsed.offsets[c.cid]
        coef.append(parsed.coef[lo:lo + rows * cols * 64].reshape(rows, cols, 64).astype(np.int64))
    head = b"".join(jpeg._segment(m, p) for m, p in _segments(data)
                    if 0xE0 <= m <= 0xEF or m == 0xFE)
    ids = [c.cid for c in parsed.comps]
    scans = []
    for m, p in _segments(data, stop_at_scan=False):
        if m == 0xDA:
            ns = p[0]
            comp = tuple(ids.index(p[1 + 2 * k]) for k in range(ns))
            scans.append((comp, p[1 + 2 * ns], p[2 + 2 * ns], p[3 + 2 * ns] >> 4,
                          p[3 + 2 * ns] & 15))
    return Frame(parsed.height, parsed.width, [(c.cid, c.h, c.v, c.tq) for c in parsed.comps],
                 {c.tq: c.quant for c in parsed.comps}, coef, head, scans=scans)


def _segments(data: bytes, stop_at_scan: bool = True):
    """(marker, payload) of each segment, up to the first SOS (or all SOS
    headers too, skipping entropy-coded data)."""
    i = 2
    while i < len(data):
        if data[i] != 0xFF:
            i += 1
            continue
        m = data[i + 1]
        if m == 0xFF or m == 0x00 or 0xD0 <= m <= 0xD7 or m == 0xD8:
            i += 1 if m == 0xFF else 2
            continue
        if m == 0xD9:
            return
        length = int.from_bytes(data[i + 2:i + 4], "big")
        payload = data[i + 4:i + 2 + length]
        yield m, payload
        i += 2 + length
        if m == 0xDA and stop_at_scan:
            return


def _mcu_blocks(frame: Frame, comp: Sequence[int]) -> List[List[Tuple[int, int, int]]]:
    """The scan's MCUs in order, each a list of (slot, row, col): a
    one-component scan takes the component's own blocks one an MCU."""
    if len(comp) == 1:
        bh, bw = frame.own_blocks(comp[0])
        return [[(0, r, q)] for r in range(bh) for q in range(bw)]
    mcuy, mcux = frame.mcus
    out = []
    for my in range(mcuy):
        for mx in range(mcux):
            mcu = []
            for slot, ci in enumerate(comp):
                _, h, v, _ = frame.comps[ci]
                mcu += [(slot, my * v + dv, mx * h + dh) for dv in range(v) for dh in range(h)]
            out.append(mcu)
    return out


def _tables_segment(frame: Frame) -> bytes:
    out = []
    for tq, q in sorted(frame.quant.items()):
        q = np.asarray(q, np.int64)[ZIGZAG]
        if q.max() > 255:
            out.append(jpeg._segment(0xDB, bytes([0x10 | tq]) + q.astype(">u2").tobytes()))
        else:
            out.append(jpeg._segment(0xDB, bytes([tq]) + q.astype(np.uint8).tobytes()))
    return b"".join(out)


def _sof(frame: Frame, marker: int) -> bytes:
    body = bytes([frame.precision]) + frame.height.to_bytes(2, "big") + \
        frame.width.to_bytes(2, "big") + bytes([len(frame.comps)])
    for cid, h, v, tq in frame.comps:
        body += bytes([cid, h << 4 | v, tq])
    return jpeg._segment(marker, body)


def _sos(frame: Frame, comp: Sequence[int], tables: Sequence[Tuple[int, int]], ss: int,
         se: int, ah: int, al: int) -> bytes:
    body = bytes([len(comp)])
    for ci, (td, ta) in zip(comp, tables):
        body += bytes([frame.comps[ci][0], td << 4 | ta])
    return jpeg._segment(0xDA, body + bytes([ss, se, ah << 4 | al]))


# ---------------------------------------------------------------------------
# Huffman
# ---------------------------------------------------------------------------


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, code: int, length: int) -> None:
        self.acc = (self.acc << length) | (code & ((1 << length) - 1))
        self.n += length
        while self.n >= 8:
            self.n -= 8
            b = (self.acc >> self.n) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def flush(self) -> None:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _flat_table(symbols: Sequence[int]) -> Tuple[bytes, bytes]:
    """A DHT table giving every symbol one code length (no all-ones code)."""
    length = max(1, len(symbols)).bit_length()
    bits = bytearray(16)
    bits[length - 1] = len(symbols)
    return bytes(bits), bytes(symbols)


def _size(v: int) -> int:
    return abs(v).bit_length()


def write_huffman(frame: Frame, restart: int = 0) -> bytes:
    """One interleaved sequential Huffman scan of every component
    (non-interleaved for one component); component 0 takes tables 0, the
    rest tables 1. 8-bit frames use the Annex K tables, 12-bit frames flat
    tables over every symbol their sizes allow."""
    if frame.precision == 8:
        dht = {k: jpeg._STD_HUFFMAN[k] for k in ((0, 0), (1, 0), (0, 1), (1, 1))}
    else:
        dc = _flat_table(list(range(16)))
        ac = _flat_table([0x00, 0xF0] + [r << 4 | s for r in range(16) for s in range(1, 15)])
        dht = {(0, 0): dc, (1, 0): ac, (0, 1): dc, (1, 1): ac}
    codes = {k: jpeg._code_table(*t) for k, t in dht.items()}
    comp = list(range(len(frame.comps)))
    tab = [0 if ci == 0 else 1 for ci in comp]
    w = _BitWriter()
    pred = [0] * len(comp)
    for n, mcu in enumerate(_mcu_blocks(frame, comp)):
        if restart and n and n % restart == 0:
            w.flush()
            w.out += bytes([0xFF, 0xD0 + (n // restart - 1) % 8])
            pred = [0] * len(comp)
        for slot, r, q in mcu:
            blk = frame.coef[comp[slot]][r, q][ZIGZAG].tolist()
            t = tab[slot]
            dcode, dlen = codes[(0, t)]
            acode, alen = codes[(1, t)]
            diff = blk[0] - pred[slot]
            pred[slot] = blk[0]
            s = _size(diff)
            w.put(int(dcode[s]), int(dlen[s]))
            if s:
                w.put(diff if diff >= 0 else diff + (1 << s) - 1, s)
            run = 0
            last = max([k for k in range(1, 64) if blk[k]], default=0)
            for k in range(1, last + 1):
                v = blk[k]
                if not v:
                    run += 1
                    continue
                while run > 15:
                    w.put(int(acode[0xF0]), int(alen[0xF0]))
                    run -= 16
                s = _size(v)
                sym = run << 4 | s
                w.put(int(acode[sym]), int(alen[sym]))
                w.put(v if v >= 0 else v + (1 << s) - 1, s)
                run = 0
            if last < 63:
                w.put(int(acode[0]), int(alen[0]))
    w.flush()
    marker = 0xC0 if frame.precision == 8 else 0xC1
    out = [b"\xff\xd8", frame.head, _tables_segment(frame), _sof(frame, marker)]
    for (tc, th), (bits, vals) in sorted(dht.items(), key=lambda kv: (kv[0][1], kv[0][0])):
        if th == 0 or len(comp) > 1:
            out.append(jpeg._segment(0xC4, bytes([tc << 4 | th]) + bits + vals))
    if restart:
        out.append(jpeg._segment(0xDD, restart.to_bytes(2, "big")))
    out += [_sos(frame, comp, [(t, t) for t in tab], 0, 63, 0, 0), bytes(w.out), b"\xff\xd9"]
    return b"".join(out)


# ---------------------------------------------------------------------------
# arithmetic (jcarith.c)
# ---------------------------------------------------------------------------


class _ArithEncoder:
    """``jcarith.c``'s QM encoder: ``arith_encode`` and ``finish_pass``."""

    def __init__(self):
        self.out = bytearray()
        self.reset()

    def reset(self) -> None:
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _zeros(self) -> None:
        self.out += bytes(self.zc)
        self.zc = 0

    def _byte(self, b: int) -> None:
        self.out.append(b)
        if b == 0xFF:
            self.out.append(0)

    def _stacked(self) -> None:
        """Output the stacked 0xFF bytes, which no longer overflow."""
        if self.sc:
            self._zeros()
            self.out += b"\xff\x00" * self.sc
            self.sc = 0

    def encode(self, st: bytearray, i: int, val: int) -> None:
        sv = st[i]
        qe, nl, nm = QE_TABLE[sv & 0x7F]
        self.a -= qe
        if val != (sv >> 7):
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._zeros()
                        self._byte(self.buffer + 1)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._zeros()
                        self._byte(self.buffer)
                    self._stacked()
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._zeros()
                self._byte(self.buffer + 1)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._zeros()
                self._byte(self.buffer)
            self._stacked()
        if self.c & 0x7FFF800:
            self._zeros()
            self._byte((self.c >> 19) & 0xFF)
            if self.c & 0x7F800:
                self._byte((self.c >> 11) & 0xFF)
        out = bytes(self.out)
        self.out = bytearray()
        self.reset()
        return out


def _encode_magnitude(e: _ArithEncoder, stats: bytearray, st: int, v: int, x1: int) -> None:
    """Figures F.8 and F.9 for ``v - 1`` from bin ``st`` (the S0 + 2 / SP /
    SN bin), with the magnitude categories from bin ``x1``."""
    m = 0
    v -= 1
    if v:
        e.encode(stats, st, 1)
        m = 1
        v2 = v
        st = x1
        while v2 >> 1:
            v2 >>= 1
            e.encode(stats, st, 1)
            m <<= 1
            st += 1
    e.encode(stats, st, 0)
    st += 14
    while m >> 1:
        m >>= 1
        e.encode(stats, st, 1 if m & v else 0)


def _encode_dc(e, stats, ctx: List[int], slot: int, v: int, L: int, U: int) -> None:
    """Figure F.4 for the DC difference ``v`` of the scan's component ``slot``."""
    st = ctx[slot]
    if v == 0:
        e.encode(stats, st, 0)
        ctx[slot] = 0
        return
    e.encode(stats, st, 1)
    if v > 0:
        e.encode(stats, st + 1, 0)
        sp, ctx[slot] = st + 2, 4
    else:
        v = -v
        e.encode(stats, st + 1, 1)
        sp, ctx[slot] = st + 3, 8
    m = 0
    if v - 1:
        m = 1 << ((v - 1).bit_length() - 1)
    if m < (1 << L) >> 1:
        ctx[slot] = 0
    elif m > (1 << U) >> 1:
        ctx[slot] += 8
    _encode_magnitude(e, stats, sp, v, 20)


def _encode_ac_band(e, stats, fixed, coefs: List[int], ss: int, se: int, K: int) -> None:
    """Figure F.5 over zig-zag positions ``ss..se`` (values after the point
    transform)."""
    ke = se
    while ke >= ss and not coefs[ke]:
        ke -= 1
    k = ss
    while k <= ke:
        st = 3 * (k - 1)
        e.encode(stats, st, 0)
        while not coefs[k]:
            e.encode(stats, st + 1, 0)
            st += 3
            k += 1
        e.encode(stats, st + 1, 1)
        v = coefs[k]
        e.encode(fixed, 0, 0 if v > 0 else 1)
        v = abs(v)
        st += 2
        # the AC magnitude: its first category bit at st, the rest from X2
        m = 0
        v -= 1
        if v:
            e.encode(stats, st, 1)
            m = 1
            v2 = v
            if v2 >> 1:
                v2 >>= 1
                e.encode(stats, st, 1)
                m <<= 1
                st = 189 if k <= K else 217
                while v2 >> 1:
                    v2 >>= 1
                    e.encode(stats, st, 1)
                    m <<= 1
                    st += 1
        e.encode(stats, st, 0)
        st += 14
        while m >> 1:
            m >>= 1
            e.encode(stats, st, 1 if m & v else 0)
        k += 1
    if k <= se:
        e.encode(stats, 3 * (k - 1), 1)


def _point(v: int, al: int) -> int:
    """An AC coefficient after the point transform: rounded toward zero."""
    return (v >> al) if v >= 0 else -((-v) >> al)


def simple_progression(ncomps: int) -> List[Tuple[Tuple[int, ...], int, int, int, int]]:
    """``jcparam.c``'s ``jpeg_simple_progression`` (PIL's ten scans for
    YCbCr; six scans of each component otherwise)."""
    allc = tuple(range(ncomps))
    if ncomps == 3:
        return [(allc, 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1),
                ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
                (allc, 0, 0, 1, 0), ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0),
                ((0,), 1, 63, 1, 0)]
    one = [(c,) for c in allc]
    return ([(allc, 0, 0, 0, 1)] + [(c, 1, 5, 0, 2) for c in one]
            + [(c, 6, 63, 0, 2) for c in one] + [(c, 1, 63, 2, 1) for c in one]
            + [(allc, 0, 0, 1, 0)] + [(c, 1, 63, 1, 0) for c in one])


def custom_progression(ncomps: int) -> List[Tuple[Tuple[int, ...], int, int, int, int]]:
    """A second script: DC first of each component alone at Al 2, two DC
    refinements (the first interleaved), AC bands 1-9 at Al 1 and 10-63 at
    Al 0 a component, then the bands' last bit."""
    allc = tuple(range(ncomps))
    one = [(c,) for c in allc]
    return ([(c, 0, 0, 0, 2) for c in one] + [(allc, 0, 0, 2, 1)]
            + [(c, 1, 9, 0, 1) for c in one] + [(c, 0, 0, 1, 0) for c in one]
            + [(c, 10, 63, 0, 0) for c in one] + [(c, 1, 9, 1, 0) for c in one])


def write_arith(frame: Frame, progressive: bool = False,
                script: Optional[Sequence[Tuple[Tuple[int, ...], int, int, int, int]]] = None,
                dac: Optional[Dict[int, Tuple[int, int, int]]] = None, restart: int = 0) -> bytes:
    """The frame's coefficients arithmetic-coded (``jcarith.c``): SOF9 with
    one interleaved sequential scan, or SOF10 with ``script`` (default
    :func:`simple_progression`). ``dac`` maps a table number to its
    conditioning (L, U, Kx) and writes a DAC segment; component 0 takes
    tables 0, the rest tables 1."""
    ncomp = len(frame.comps)
    tab = [0 if ci == 0 else 1 for ci in range(ncomp)]
    cond = {t: (0, 1, 5) for t in (0, 1)}
    if dac:
        cond.update(dac)
    if progressive:
        script = list(script) if script is not None else simple_progression(ncomp)
    else:
        script = [(tuple(range(ncomp)), 0, 63, 0, 0)]
    zz = [frame.coef[ci].reshape(-1, 64)[:, ZIGZAG].reshape(frame.coef[ci].shape).tolist()
          for ci in range(ncomp)]
    e = _ArithEncoder()
    fixed = bytearray([113])
    scans = []
    for comp, ss, se, ah, al in script:
        dc_stats = {t: bytearray(64) for t in (0, 1)}
        ac_stats = {t: bytearray(256) for t in (0, 1)}
        last = [0] * len(comp)
        ctx = [0] * len(comp)
        data = bytearray()
        for n, mcu in enumerate(_mcu_blocks(frame, comp)):
            if restart and n and n % restart == 0:
                data += e.finish() + bytes([0xFF, 0xD0 + (n // restart - 1) % 8])
                for t in (0, 1):
                    dc_stats[t][:] = bytes(64)
                    ac_stats[t][:] = bytes(256)
                last = [0] * len(comp)
                ctx = [0] * len(comp)
            for slot, r, q in mcu:
                blk = zz[comp[slot]][r][q]
                t = tab[comp[slot]]
                L, U, K = cond[t]
                if not progressive:
                    _encode_dc(e, dc_stats[t], ctx, slot, blk[0] - last[slot], L, U)
                    last[slot] = blk[0]
                    _encode_ac_band(e, ac_stats[t], fixed, blk, 1, 63, K)
                elif ss == 0 and not ah:
                    m = blk[0] >> al
                    _encode_dc(e, dc_stats[t], ctx, slot, m - last[slot], L, U)
                    last[slot] = m
                elif ss == 0:
                    e.encode(fixed, 0, (blk[0] >> al) & 1)
                elif not ah:
                    band = [0] * 64
                    band[ss:se + 1] = [_point(v, al) for v in blk[ss:se + 1]]
                    _encode_ac_band(e, ac_stats[t], fixed, band, ss, se, K)
                else:
                    _encode_ac_refine(e, ac_stats[t], fixed, blk, ss, se, ah, al)
        data += e.finish()
        tables = [(tab[ci], tab[ci]) for ci in comp]
        scans.append(_sos(frame, comp, tables, ss, se, ah, al) + bytes(data))
    out = [b"\xff\xd8", frame.head, _tables_segment(frame),
           _sof(frame, 0xCA if progressive else 0xC9)]
    if dac:
        body = b""
        for t, (L, U, K) in sorted(dac.items()):
            body += bytes([t, U << 4 | L, 0x10 | t, K])
        out.append(jpeg._segment(0xCC, body))
    if restart:
        out.append(jpeg._segment(0xDD, restart.to_bytes(2, "big")))
    out += scans + [b"\xff\xd9"]
    return b"".join(out)


def _encode_ac_refine(e, stats, fixed, blk: List[int], ss: int, se: int, ah: int,
                      al: int) -> None:
    """``encode_mcu_AC_refine``: the bit ``al`` of the band ``ss..se``."""
    mag = [abs(v) >> al for v in blk]
    ke = se
    while ke > 0 and not mag[ke]:
        ke -= 1
    kex = ke
    while kex > 0 and not (abs(blk[kex]) >> ah):
        kex -= 1
    k = ss
    while k <= ke:
        st = 3 * (k - 1)
        if k > kex:
            e.encode(stats, st, 0)
        while True:
            v = mag[k]
            if v:
                if v >> 1:
                    e.encode(stats, st + 2, v & 1)
                else:
                    e.encode(stats, st + 1, 1)
                    e.encode(fixed, 0, 0 if blk[k] > 0 else 1)
                break
            e.encode(stats, st + 1, 0)
            st += 3
            k += 1
        k += 1
    if k <= se:
        e.encode(stats, 3 * (k - 1), 1)


def transcode_arith(data: bytes, progressive: Optional[bool] = None, script=None,
                    dac=None, restart: int = 0) -> bytes:
    """``jpegtran -arithmetic``: a Huffman file's coefficients and APPn
    segments arithmetic-coded; ``progressive`` None keeps the file's mode
    and, when progressive, its own scan script."""
    frame = read_frame(data)
    was_progressive = any(s[1] or s[2] != 63 or s[3] or s[4] for s in frame.scans)
    if progressive is None:
        progressive = was_progressive
    if progressive and script is None:
        script = frame.scans if was_progressive else None
    return write_arith(frame, progressive, script, dac, restart)


# ---------------------------------------------------------------------------
# lossless (SOF3)
# ---------------------------------------------------------------------------


def _predict(psv: int, ra: int, rb: int, rc: int) -> int:
    return {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
            6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[psv]


def _lossless_diffs(plane: np.ndarray, predictor: int, initial: int,
                    first_rows: int) -> np.ndarray:
    """The differences of one component's samples (after the point
    transform): the first row of the scan and every ``first_rows``-th row
    predict from ``initial`` and the left neighbour, the first column of
    the other rows from above."""
    p = plane.tolist()
    out = np.zeros(plane.shape, np.int64)
    for y in range(plane.shape[0]):
        first = y % first_rows == 0
        for x in range(plane.shape[1]):
            if first:
                pred = initial if x == 0 else p[y][x - 1]
            elif x == 0:
                pred = p[y - 1][0]
            else:
                pred = _predict(predictor, p[y][x - 1], p[y - 1][x], p[y - 1][x - 1])
            out[y, x] = ((p[y][x] - pred + 32768) & 0xFFFF) - 32768
    return out


def write_lossless(planes: Sequence[np.ndarray], predictor: int = 1, pt: int = 0,
                   restart_rows: int = 0, precision: int = 8,
                   ids: Optional[Sequence[int]] = None, head: bytes = b"",
                   marker: int = 0xC3, factors: Optional[Sequence[Tuple[int, int]]] = None,
                   size: Optional[Tuple[int, int]] = None, interleave: bool = True) -> bytes:
    """Lossless Huffman JPEG of component planes at their own sizes under
    ``factors`` (default 1x1; the image is ``size``, by default the first
    plane's): one interleaved scan (or a scan a component), predictor
    ``predictor``, point transform ``pt``, a restart every
    ``restart_rows`` MCU rows. The first sample row of the scan and of each
    interval predicts from ``1 << (P - Pt - 1)`` and its left neighbour,
    the first column of the other rows from above; samples past a
    component's own width and height in its last MCUs code a difference
    of 0."""
    n = len(planes)
    factors = list(factors) if factors else [(1, 1)] * n
    height, width = size if size is not None else np.asarray(planes[0]).shape
    hmax = max(h for h, _ in factors)
    vmax = max(v for _, v in factors)
    table = _flat_table(list(range(17)))
    code, length = jpeg._code_table(*table)
    initial = 1 << (precision - pt - 1)
    ids = list(ids) if ids is not None else list(range(1, n + 1))

    def sample_order(comp):
        """(component, row, col) of each sample in scan order, MCUs a row."""
        if len(comp) == 1:
            c = comp[0]
            ch, cw = -(-height * factors[c][1] // vmax), -(-width * factors[c][0] // hmax)
            return [[(c, y, x)] for y in range(ch) for x in range(cw)], cw
        mcuy, mcux = -(-height // vmax), -(-width // hmax)
        return [[(c, my * factors[c][1] + dv, mx * factors[c][0] + dh) for c in comp
                 for dv in range(factors[c][1]) for dh in range(factors[c][0])]
                for my in range(mcuy) for mx in range(mcux)], mcux

    scans = []
    for comp in ([tuple(range(n))] if interleave else [(c,) for c in range(n)]):
        mcus, per_row = sample_order(comp)
        grids = {}
        for c in comp:
            h, v = factors[c]
            ch, cw = -(-height * v // vmax), -(-width * h // hmax)
            plane = np.asarray(planes[c]).astype(np.int64)[:ch, :cw] >> pt
            rows_in_mcu_row = v if len(comp) > 1 else 1
            first = restart_rows * rows_in_mcu_row if restart_rows else ch
            d = _lossless_diffs(plane, predictor, initial, first)
            grids[c] = np.pad(d, ((0, ch + 4 * vmax), (0, cw + 4 * hmax)))
        w = _BitWriter()
        every = restart_rows * per_row
        for k, mcu in enumerate(mcus):
            if every and k and k % every == 0:
                w.flush()
                w.out += bytes([0xFF, 0xD0 + (k // every - 1) % 8])
            for c, y, x in mcu:
                d = int(grids[c][y, x])
                s_ = 16 if d == -32768 else _size(d)
                w.put(int(code[s_]), int(length[s_]))
                if 0 < s_ < 16:
                    w.put(d if d >= 0 else d + (1 << s_) - 1, s_)
        w.flush()
        sos = bytes([len(comp)]) + b"".join(bytes([ids[c], 0x00]) for c in comp) + \
            bytes([predictor, 0, pt])
        dri = jpeg._segment(0xDD, every.to_bytes(2, "big")) if every else b""
        scans.append(dri + jpeg._segment(0xDA, sos) + bytes(w.out))
    sof = bytes([precision]) + height.to_bytes(2, "big") + width.to_bytes(2, "big") + \
        bytes([n]) + b"".join(bytes([i, h << 4 | v, 0]) for i, (h, v) in zip(ids, factors))
    out = [b"\xff\xd8", head, jpeg._segment(marker, sof),
           jpeg._segment(0xC4, b"\x00" + table[0] + table[1])]
    return b"".join(out + scans + [b"\xff\xd9"])


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def cmyk_to_ycck(cmyk: np.ndarray) -> List[np.ndarray]:
    """``jccolor.c``'s ``cmyk_ycck_convert``: Y, Cb, Cr of (255 - C, 255 - M,
    255 - Y), K unchanged."""
    y, cb, cr = jpeg.rgb_to_ycc(255 - cmyk[:, :, :3])
    return [y, cb, cr, cmyk[:, :, 3].astype(np.int64)]


def scan_starts(data: bytes) -> List[int]:
    """The offset of every SOS marker, found segment by segment."""
    out, i = [], 2
    while i < len(data) - 1:
        if data[i] != 0xFF or data[i + 1] in (0x00, 0xFF) or 0xD0 <= data[i + 1] <= 0xD7:
            i += 1
            continue
        if data[i + 1] == 0xD9:
            break
        if data[i + 1] == 0xDA:
            out.append(i)
        length = int.from_bytes(data[i + 2:i + 4], "big")
        i += 2 + length
    return out


def cut_after(data: bytes, scans: int) -> bytes:
    """The file with only its first ``scans`` scans, then EOI."""
    return data[:scan_starts(data)[scans]] + b"\xff\xd9"


def subsampled(img: np.ndarray, factors: Sequence[Tuple[int, int]]) -> List[np.ndarray]:
    """Each channel of ``img`` box-averaged to its component's own size
    under ``factors`` (any planes do; these keep the colours close)."""
    height, width = img.shape[:2]
    hmax = max(h for h, _ in factors)
    vmax = max(v for _, v in factors)
    out = []
    for c, (h, v) in enumerate(factors):
        fy, fx = vmax // v, hmax // h
        ch, cw = -(-height // fy), -(-width // fx)
        p = np.pad(img[:, :, c % img.shape[2]].astype(np.int64),
                   ((0, ch * fy - height), (0, cw * fx - width)), mode="edge")
        out.append(((p.reshape(ch, fy, cw, fx).sum(axis=(1, 3)) + fy * fx // 2)
                    // (fy * fx)).astype(np.uint8))
    return out


def exif_orientation(value: int) -> bytes:
    """An APP1 segment whose Exif block sets orientation ``value``
    (big-endian TIFF, the tag alone in IFD0)."""
    tiff = b"MM" + struct.pack(">HI", 42, 8) + struct.pack(">H", 1) + \
        struct.pack(">HHIHH", 0x0112, 3, 1, value, 0) + struct.pack(">I", 0)
    return jpeg._segment(0xE1, b"Exif\x00\x00" + tiff)


# ---------------------------------------------------------------------------
# the kinds as files, and their goldens
# ---------------------------------------------------------------------------

HERE = os.path.dirname(os.path.abspath(__file__))
KINDS_DIR = os.path.join(HERE, "jpeg_kinds")
GOLDENS = os.path.join(KINDS_DIR, "goldens.json")


def _shipped(name: str) -> bytes:
    with open(os.path.join(KINDS_DIR, name), "rb") as f:
        return f.read()


def _patch_sof(data: bytes, marker: int) -> bytes:
    i = data.index(b"\xff\xc0")
    return data[:i + 1] + bytes([marker]) + data[i + 2:]


def fixtures() -> Dict[str, bytes]:
    """Every kind the port reads or refuses, one small file each, made by
    the writers above from seeded numpy images (and two files PIL wrote,
    shipped under ``tests/jpeg_kinds/``: a progressive q85 file and a
    CMYK one)."""
    q = jpeg.quant_tables(85)
    out: Dict[str, bytes] = {}
    base = jpeg.encode_jpeg(photo(37, 53, 1), 90)
    out["arith-seq-420"] = transcode_arith(base)
    out["arith-seq-420-dac-rst"] = transcode_arith(base, dac={0: (1, 4, 2), 1: (0, 2, 12)},
                                                   restart=2)
    out["arith-prog-420"] = transcode_arith(base, progressive=True)
    f444 = frame_from_planes([photo(9, 17, 2)[:, :, k] for k in range(3)], [(1, 1)] * 3,
                             [q[0], q[1], q[1]], head=b"")
    out["arith-prog-custom-444-9x17"] = write_arith(f444, True, custom_progression(3),
                                                    restart=3)
    out["arith-grey-1x1"] = transcode_arith(jpeg.encode_jpeg(photo(1, 1, 3), 75))
    prog = _shipped("pil_progressive_q85_40x56.jpg")
    arith_prog = transcode_arith(prog)
    for keep in (1, 3, 6, 9):
        out[f"huffman-prog-cut-{keep}"] = cut_after(prog, keep)
        out[f"arith-prog-cut-{keep}"] = cut_after(arith_prog, keep)
    cmyk = _shipped("pil_cmyk_q90_37x53.jpg")
    out["cmyk-pil"] = cmyk
    bare = read_frame(cmyk)
    bare.head = b""
    out["cmyk-no-adobe"] = write_huffman(bare)
    ink = photo(37, 53, 12, channels=4)
    fac = [(2, 2), (1, 1), (1, 1), (2, 2)]
    ycck = frame_from_planes(subsampled(np.stack(cmyk_to_ycck(ink), -1).clip(0, 255)
                                        .astype(np.uint8), fac), fac,
                             [q[0], q[1], q[1], q[0]], head=adobe(2), size=(37, 53))
    out["ycck-2x2"] = write_huffman(ycck)
    out["ycck-arith-prog"] = write_arith(ycck, progressive=True, script=simple_progression(4))
    for fac in ([(4, 1), (1, 1), (1, 1)], [(3, 1), (1, 1), (1, 1)], [(1, 3), (1, 1), (1, 1)],
                [(3, 2), (1, 1), (1, 1)], [(4, 2), (1, 1), (1, 1)], [(1, 4), (1, 1), (1, 1)],
                [(2, 2), (2, 1), (1, 2)], [(4, 1), (2, 1), (2, 1)]):
        name = "sampling-" + "-".join(f"{h}{v}" for h, v in fac)
        f = frame_from_planes(subsampled(photo(37, 53, 4), fac), fac, [q[0], q[1], q[1]],
                              size=(37, 53))
        out[name] = write_huffman(f)
    grey = photo(37, 53, 2)[:, :, 0]
    for psv, pt, rows in ((1, 0, 0), (4, 2, 3), (7, 1, 1)):
        out[f"lossless-grey-p{psv}"] = write_lossless([grey], psv, pt, rows)
    rgb = photo(9, 17, 5)
    out["lossless-rgb-p6"] = write_lossless([rgb[:, :, k] for k in range(3)], 6, 1, 2,
                                            ids=[82, 71, 66])
    out["lossless-cmyk-p5"] = write_lossless([rgb[:, :, k] for k in (0, 1, 2, 1)], 5)
    sub = [(2, 2), (1, 1), (1, 1)]
    out["lossless-sub-22"] = write_lossless(subsampled(photo(37, 53, 6), sub), 4, 0, 2,
                                            factors=sub, size=(37, 53), ids=[82, 71, 66])
    out["cmyk-exif6"] = cmyk[:2] + exif_orientation(6) + cmyk[2:]
    arith = out["arith-seq-420"]
    out["arith-exif3"] = arith[:2] + exif_orientation(3) + arith[2:]
    # the refusals: both libraries refuse each, but the last on cv2 alone
    f12 = frame_from_planes([grey], [(1, 1)], [q[0]])
    f12.precision = 12
    f12.coef = [c * 16 for c in f12.coef]
    out["refuse-12-bit"] = write_huffman(f12)
    huff = jpeg.encode_jpeg(photo(9, 17, 8), 75)
    for m in (0xC5, 0xC7, 0xCD, 0xCF):
        out[f"refuse-sof{m - 0xC0}"] = _patch_sof(huff, m)
    i = huff.index(b"\xff\xc0")
    out["refuse-dnl"] = huff[:i + 5] + b"\x00\x00" + huff[i + 7:]
    out["refuse-2-component"] = write_huffman(frame_from_planes(
        [grey, grey], [(1, 1), (1, 1)], [q[0], q[1]]))
    fract = [(3, 1), (2, 1), (1, 1)]
    out["refuse-fractional-31-21"] = write_huffman(frame_from_planes(
        subsampled(photo(37, 53, 4), fract), fract, [q[0], q[1], q[1]], size=(37, 53)))
    out["refuse-sof11"] = write_lossless([grey], 1, marker=0xCB)
    out["refuse-lossless-ycc"] = write_lossless([rgb[:, :, k] for k in range(3)], 1, head=JFIF)
    out["refuse-lossless-16-bit"] = write_lossless([grey.astype(np.int64) * 257], 1,
                                                   precision=16)
    return out


def sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def pixels_sha(rgb: np.ndarray) -> str:
    """The hash of an image's shape and its uint8 bytes."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    return sha(str(rgb.shape).encode() + rgb.tobytes())


def record_goldens(kinds: Optional[Dict[str, bytes]] = None) -> dict:
    """Each fixture's byte hash and, on each route, its pixels' hash or
    "refused": ``cv2`` the JAX package's ``read_rgb`` (``cv2.imread`` then
    BGR to RGB, with the EXIF turn), ``pil`` ``Image.open(...).convert("RGB")``."""
    import io

    import cv2
    from PIL import Image

    kinds = fixtures() if kinds is None else kinds
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, data in kinds.items():
            path = os.path.join(tmp, name + ".jpg")
            with open(path, "wb") as f:
                f.write(data)
            bgr = cv2.imread(path)
            try:
                pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
            except Exception:  # noqa: BLE001 - any refusal of PIL's
                pil = None
            out[name] = {
                "bytes": sha(data),
                "cv2": "refused" if bgr is None else pixels_sha(
                    np.ascontiguousarray(bgr[:, :, ::-1])),
                "pil": "refused" if pil is None else pixels_sha(pil)}
    return out


def port_against_goldens(goldens: dict, reps: int = 1) -> Dict[str, Dict[str, object]]:
    """Hold the port to ``goldens`` on every fixture: the bytes, then
    ``read_rgb`` against the cv2 golden and ``read_rgb_pil`` and
    ``decode_rgb`` against PIL's, a refusal (``NotImplementedError``, or
    ``ValueError`` for a file the standard forbids) where the golden says
    "refused". Returns each route's decode ms (best of ``reps``) or
    "refused"; raises ``AssertionError`` at the first difference."""
    import time

    from maskclustering_tpu_torch.io.image import decode_rgb, read_rgb, read_rgb_pil

    kinds = fixtures()
    if sorted(kinds) != sorted(goldens):
        raise AssertionError(f"fixtures {sorted(set(kinds) ^ set(goldens))} have no golden "
                             f"or no file")
    out: Dict[str, Dict[str, object]] = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, data in kinds.items():
            want = goldens[name]
            if sha(data) != want["bytes"]:
                raise AssertionError(f"{name}: the writers made other bytes than the golden's")
            path = os.path.join(tmp, name + ".jpg")
            with open(path, "wb") as f:
                f.write(data)
            row: Dict[str, object] = {}
            for route, golden, read in (("read_rgb", want["cv2"], lambda: read_rgb(path)),
                                        ("read_rgb_pil", want["pil"], lambda: read_rgb_pil(path)),
                                        ("decode_rgb", want["pil"], lambda: decode_rgb(data))):
                times = []
                for _ in range(reps):
                    t0 = time.perf_counter()
                    try:
                        got = read()
                    except (NotImplementedError, ValueError) as err:
                        if golden != "refused":
                            raise AssertionError(f"{name}: {route} refuses a file its library "
                                                 f"reads: {err}") from err
                        got = None
                    times.append((time.perf_counter() - t0) * 1e3)
                if got is None:
                    row[route] = "refused"
                    continue
                if golden == "refused":
                    raise AssertionError(f"{name}: {route} reads a file its library refuses")
                if pixels_sha(got) != golden:
                    raise AssertionError(f"{name}: {route} differs from its library's pixels")
                row[route] = min(times)
            out[name] = row
    return out


if __name__ == "__main__":
    goldens = record_goldens()
    with open(GOLDENS, "w") as f:
        json.dump(goldens, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"{len(goldens)} kinds -> {GOLDENS}")
