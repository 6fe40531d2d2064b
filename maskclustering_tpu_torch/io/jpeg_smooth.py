"""libjpeg-turbo's block smoothing of progressive JPEG (``jdcoefct.c``).

A progressive file whose scans leave some of a component's first nine AC
coefficients short of full precision (its last scans cut, or never sent)
is decoded by libjpeg, and so by PIL and cv2, with those coefficients
estimated from the DC values of the block and its 24 neighbours
(``decompress_smooth_data``, libjpeg-turbo 2.1 and later):

- ``smoothing_ok``: every component has its DC at least partly and a
  nonzero quantiser at the ten positions; some component lacks bits of a
  coefficient 1-9. ``coef_bits`` is the point transform each coefficient
  has reached at the end of the file (-1: never sent), latched once, as
  the non-buffered decode reads every scan before its output pass;
- each estimate is made only where the stored coefficient is 0 and not
  known to full precision, clamped below ``1 << Al`` when ``Al`` > 0;
  with no AC data at all for the component (``change_dc``) the estimates
  come from a Gaussian-like 5x5 kernel, coefficients 1-9 and the DC too;
- the 5x5 window's rows are chosen as libjpeg chooses them: by the block
  row's number computed from its iMCU row's own count of block rows (the
  last iMCU row's may be shorter), padding rows of the MCU grid included;
  its columns replicate the component's edge blocks.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

# natural-order positions of zig-zag coefficients 1-9
_POS = (1, 8, 16, 9, 2, 3, 10, 17, 24)


def smoothing_ok(quants: Sequence[np.ndarray], coef_bits: Sequence[Sequence[int]]) -> bool:
    """``smoothing_ok`` over all components: ``coef_bits[c][k]`` for k < 10."""
    useful = False
    for q, bits in zip(quants, coef_bits):
        if q[0] == 0 or any(q[p] == 0 for p in _POS):
            return False
        if bits[0] < 0:
            return False
        if any(b != 0 for b in bits[1:10]):
            useful = True
    return useful


def _row_window(rows: int, v: int, imcu_rows: int) -> np.ndarray:
    """(rows, 5): the grid row of each of the five window rows of each
    block row (``prev_prev_block_row`` .. ``next_next_block_row``)."""
    out = []
    for r in range(imcu_rows):
        block_rows = v if r < imcu_rows - 1 else (rows % v or v)
        image_block_rows = block_rows * imcu_rows
        for br in range(block_rows):
            image_block_row = r * block_rows + br
            row = r * v + br
            prev = row - 1 if image_block_row > 0 else row
            prev_prev = row - 2 if image_block_row > 1 else prev
            nxt = row + 1 if image_block_row < image_block_rows - 1 else row
            next_next = row + 2 if image_block_row < image_block_rows - 2 else nxt
            out.append((prev_prev, prev, row, nxt, next_next))
    return np.asarray(out[:rows], np.int64)


def _col_window(cols: int) -> np.ndarray:
    """(cols, 5): the grid column of each of the five DC registers of a row
    at each block column, the edge columns replicated."""
    return np.clip(np.arange(cols)[:, None] + np.arange(-2, 3)[None, :], 0, cols - 1)


def _predict(num: np.ndarray, q: int, al: int) -> np.ndarray:
    """``pred`` from ``num`` over the quantiser ``q``: C's division of the
    magnitude, clamped below ``1 << al`` when ``al`` > 0, then the sign."""
    mag = ((q << 7) + np.abs(num)) // (q << 8)
    if al > 0:
        mag = np.minimum(mag, (1 << al) - 1)
    return np.where(num >= 0, mag, -mag)


def smooth_component(grid: np.ndarray, rows: int, cols: int, v: int, imcu_rows: int,
                     quant: np.ndarray, coef_bits: Sequence[int]) -> np.ndarray:
    """``decompress_smooth_data`` over one component: ``grid`` its
    (grid rows, grid cols, 64) natural-order coefficients, ``rows`` x
    ``cols`` its own blocks. Returns the smoothed (rows, cols, 64) blocks
    that its IDCT reads."""
    dc = grid[:, :, 0].astype(np.int64)
    rw, cw = _row_window(rows, v, imcu_rows), _col_window(cols)
    # DC[n] is libjpeg's DCnn, n = 5 * window row + window column + 1
    DC = [None] + [dc[rw[:, i]][:, cw[:, j]] for i in range(5) for j in range(5)]
    out = grid[:rows, :cols].astype(np.int64).copy()
    q = [int(x) for x in np.asarray(quant, np.int64)]
    q00 = q[0]
    change_dc = all(b == -1 for b in coef_bits[1:10])
    if change_dc:
        kernels = (
            -DC[1] - DC[2] + DC[4] + DC[5] - 3 * DC[6] + 13 * DC[7] - 13 * DC[9] + 3 * DC[10]
            - 3 * DC[11] + 38 * DC[12] - 38 * DC[14] + 3 * DC[15] - 3 * DC[16] + 13 * DC[17]
            - 13 * DC[19] + 3 * DC[20] - DC[21] - DC[22] + DC[24] + DC[25],
            -DC[1] - 3 * DC[2] - 3 * DC[3] - 3 * DC[4] - DC[5] - DC[6] + 13 * DC[7]
            + 38 * DC[8] + 13 * DC[9] - DC[10] + DC[16] - 13 * DC[17] - 38 * DC[18]
            - 13 * DC[19] + DC[20] + DC[21] + 3 * DC[22] + 3 * DC[23] + 3 * DC[24] + DC[25],
            DC[3] + 2 * DC[7] + 7 * DC[8] + 2 * DC[9] - 5 * DC[12] - 14 * DC[13] - 5 * DC[14]
            + 2 * DC[17] + 7 * DC[18] + 2 * DC[19] + DC[23],
            -DC[1] + DC[5] + 9 * DC[7] - 9 * DC[9] - 9 * DC[17] + 9 * DC[19] + DC[21] - DC[25],
            2 * DC[7] - 5 * DC[8] + 2 * DC[9] + DC[11] + 7 * DC[12] - 14 * DC[13]
            + 7 * DC[14] + DC[15] + 2 * DC[17] - 5 * DC[18] + 2 * DC[19],
            DC[7] - DC[9] + 2 * DC[12] - 2 * DC[14] + DC[17] - DC[19],
            DC[7] - 3 * DC[8] + DC[9] - DC[17] + 3 * DC[18] - DC[19],
            DC[7] - DC[9] - 3 * DC[12] + 3 * DC[14] + DC[17] - DC[19],
            DC[7] + 2 * DC[8] + DC[9] - DC[17] - 2 * DC[18] - DC[19])
    else:
        kernels = (
            -7 * DC[11] + 50 * DC[12] - 50 * DC[14] + 7 * DC[15],
            -7 * DC[3] + 50 * DC[8] - 50 * DC[18] + 7 * DC[23],
            -DC[3] + 13 * DC[8] - 24 * DC[13] + 13 * DC[18] - DC[23],
            DC[10] + DC[16] - 10 * DC[17] + 10 * DC[19] - DC[2] - DC[20] + DC[22] - DC[24]
            + DC[4] - DC[6] + 10 * DC[7] - 10 * DC[9],
            -DC[11] + 13 * DC[12] - 24 * DC[13] + 13 * DC[14] - DC[15])
    for k, (pos, kernel) in enumerate(zip(_POS, kernels), start=1):
        al = coef_bits[k]
        if al == 0:
            continue
        pred = _predict(q00 * kernel, q[pos], al)
        out[:, :, pos] = np.where(out[:, :, pos] == 0, pred, out[:, :, pos])
    if change_dc:
        num = q00 * (
            -2 * DC[1] - 6 * DC[2] - 8 * DC[3] - 6 * DC[4] - 2 * DC[5] - 6 * DC[6]
            + 6 * DC[7] + 42 * DC[8] + 6 * DC[9] - 6 * DC[10] - 8 * DC[11] + 42 * DC[12]
            + 152 * DC[13] + 42 * DC[14] - 8 * DC[15] - 6 * DC[16] + 6 * DC[17] + 42 * DC[18]
            + 6 * DC[19] - 6 * DC[20] - 2 * DC[21] - 6 * DC[22] - 8 * DC[23] - 6 * DC[24]
            - 2 * DC[25])
        out[:, :, 0] = _predict(num, q00, 0)
    return out
