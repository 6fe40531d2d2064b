"""Lossless Huffman JPEG (SOF3): ``jdlhuff.c``, ``jdlossls.c``, ``jddiffct.c``.

libjpeg-turbo 3 decodes lossless files, and PIL reads those of 8-bit
precision (what PIL cannot hold it refuses at open). Each sample's
difference is a DC-table category (0-16; 16 means 32768 with no extra
bits) and its bits; the sample is the difference plus a prediction from
its undifferenced neighbours Ra (left), Rb (above) and Rc (above left),
modulo 2**16:

- the first row of the scan and of each restart interval predicts its
  first sample from ``1 << (P - Pt - 1)`` and the rest from Ra;
- every other row predicts its first sample from Rb and the rest by the
  scan's predictor: 1 Ra, 2 Rb, 3 Rc, 4 Ra + Rb - Rc, 5 Ra + ((Rb - Rc) >>
  1), 6 Rb + ((Ra - Rc) >> 1), 7 (Ra + Rb) >> 1;
- the output sample is the undifferenced value shifted up by the point
  transform Pt, in 8 bits.

An MCU holds ``h`` x ``v`` samples of each component of an interleaved
scan (one sample of a one-component scan); the differences of samples
past a component's own width and height are read and dropped
(``jddiffct.c`` undifferences ``width_in_blocks`` samples of its real
rows). A restart interval holds whole rows of MCUs, as libjpeg requires.
``jddiffct.c`` undifferences an iMCU row (``v`` rows of a component)
only after decoding all of it, so a restart anywhere in an iMCU row
gives the first-row rule to that iMCU row's first row, not to the row
where the interval starts: the two differ in a one-component scan of a
component sampled ``v`` > 1 with restarts every fewer than ``v`` rows.
"""

from __future__ import annotations

from typing import List, Sequence, Set, Tuple

import numpy as np


def _diffs(win: List[int], luts: Sequence[Tuple[List[int], List[int]]], n: int,
           nbits: int) -> List[int]:
    """``n`` sample differences, sample i through ``luts[i % len(luts)]``
    (code length and category by 16-bit peek); raises past ``nbits``."""
    out = []
    pos = 0
    k = len(luts)
    for i in range(n):
        length, symbol = luts[i % k]
        peek = (win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF
        size = length[peek]
        if not size:
            raise ValueError("corrupt JPEG data: bad Huffman code")
        pos += size
        s = symbol[peek]
        if s == 16:
            out.append(32768)
        elif s:
            bits = (win[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
            pos += s
            out.append(bits if bits >> (s - 1) else bits - (1 << s) + 1)
        else:
            out.append(0)
    if pos > nbits:
        raise ValueError("truncated JPEG: the entropy-coded data ends inside a row")
    return out


def _predict(psv: int, ra: int, rb: int, rc: int) -> int:
    if psv == 1:
        return ra
    if psv == 2:
        return rb
    if psv == 3:
        return rc
    if psv == 4:
        return ra + rb - rc
    if psv == 5:
        return ra + ((rb - rc) >> 1)
    if psv == 6:
        return rb + ((ra - rc) >> 1)
    return (ra + rb) >> 1


def undifference(diff: np.ndarray, psv: int, initial: int, first_rows: Set[int]) -> np.ndarray:
    """Undifference one component's (rows, width) differences: the rows in
    ``first_rows`` take the first-row rule, the others predictor ``psv``."""
    rows, width = diff.shape
    d = diff.tolist()
    out: List[List[int]] = []
    for r in range(rows):
        row = d[r]
        o = [0] * width
        if r in first_rows:
            ra = (row[0] + initial) & 0xFFFF
            o[0] = ra
            for i in range(1, width):
                ra = (row[i] + ra) & 0xFFFF
                o[i] = ra
        else:
            above = out[-1]
            ra = (row[0] + above[0]) & 0xFFFF
            o[0] = ra
            for i in range(1, width):
                ra = (row[i] + _predict(psv, ra, above[i], above[i - 1])) & 0xFFFF
                o[i] = ra
        out.append(o)
    return np.asarray(out, np.int64).reshape(rows, width)


def decode_scan(windows: Sequence[List[int]], nbits: Sequence[int],
                luts: Sequence[Tuple[List[int], List[int]]], slot: np.ndarray,
                rows: np.ndarray, cols: np.ndarray, per_unit: int, interval: int,
                shapes: Sequence[Tuple[int, int, int, int, int, int]], psv: int, pt: int,
                precision: int, restart_rows: int) -> List[np.ndarray]:
    """The samples of one lossless scan. Sample i of the scan (in order)
    belongs to slot ``slot[i]`` at ``(rows[i], cols[i])`` of that
    component's MCU grid; ``luts[k]`` is the k-th sample of an MCU's table;
    ``windows[j]`` holds interval j (``interval`` MCUs, ``restart_rows``
    rows of MCUs). ``shapes[s]`` is slot s's (grid rows, grid cols, own
    rows, own cols, its rows an MCU row, its rows an iMCU row). Returns
    each slot's uint8 plane at its own size."""
    grids = [np.zeros(sh[:2], np.int64) for sh in shapes]
    n = len(slot)
    for j, (win, nb) in enumerate(zip(windows, nbits)):
        lo, hi = j * interval * per_unit, min(n, (j + 1) * interval * per_unit)
        d = np.asarray(_diffs(win, luts, hi - lo, nb), np.int64)
        for k, grid in enumerate(grids):
            sel = slot[lo:hi] == k
            grid[rows[lo:hi][sel], cols[lo:hi][sel]] = d[sel]
    initial = 1 << (precision - pt - 1)
    out = []
    for grid, (_, _, h, w, mcu_rows, imcu_rows) in zip(grids, shapes):
        # each interval's first MCU row, and the iMCU row it falls in
        first = {r * mcu_rows // imcu_rows * imcu_rows
                 for r in range(0, -(-h // mcu_rows), restart_rows)}
        samples = undifference(grid[:h, :w], psv, initial, first)
        out.append(((samples << pt) & 0xFF).astype(np.uint8))
    return out
