"""Edge cases of the ball-query contract, shared by the port's tests and
``chip_smoke.py``.

Each case is ``(q (B, P, 3) f32, c (B, S, 3) f32, ql (B,) i32, cl (B,) i32,
k, radius)``, made with numpy from a fixed seed or planted by hand. The
planted cases aim at the CUDA kernel's structure (``ops/cuda/ball_query.cu``):
warp steps of 128 candidates, 4 consecutive ones a lane, ranked by votes; 4
query rows a warp and 16 a block; tiles of 1024 candidates in a ring of 3
buffers; and bulk copies that need S % 4 == 0.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

Case = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int, float]


def _uniform(seed: int, lo: float, hi: float, b: int, p: int, s: int):
    rng = np.random.default_rng(seed)
    return (rng.uniform(lo, hi, (b, p, 3)).astype(np.float32),
            rng.uniform(lo, hi, (b, s, 3)).astype(np.float32))


def _planted(hits: Sequence[Sequence[int]], s: int, cl: int, k: int) -> Case:
    """One batch element whose row p sits at (p, 0, 0), a unit apart. The
    candidates listed in ``hits[p]`` lie 0.05 from row p, inside its radius
    of 0.1 and outside every other row's; the rest lie far from all rows."""
    p = len(hits)
    q = np.zeros((1, p, 3), np.float32)
    q[0, :, 0] = np.arange(p)
    c = np.full((1, s, 3), -10.0, np.float32)
    if len({i for idxs in hits for i in idxs}) != sum(len(idxs) for idxs in hits):
        raise ValueError("a planted candidate can belong to one row only")
    for row, idxs in enumerate(hits):
        c[0, list(idxs)] = q[0, row] + np.float32([0.05, 0.0, 0.0])
    return q, c, np.array([p], np.int32), np.array([cl], np.int32), k, 0.1


def _ragged() -> Case:  # ql = 0 and cl = 1 rows included
    q, c = _uniform(1, -1, 1, 4, 70, 260)
    return q, c, np.array([70, 33, 0, 64], np.int32), np.array([260, 100, 50, 1], np.int32), 6, 0.4


def _scan_order() -> Case:  # first k by index, not the nearest k
    return (np.zeros((1, 1, 3), np.float32),
            np.array([[[0.3, 0, 0], [0.1, 0, 0], [0.2, 0, 0]]], np.float32),
            np.array([1], np.int32), np.array([3], np.int32), 2, 0.5)


def _chunked() -> Case:  # b above the Pallas kernel's batch chunk
    q, c = _uniform(2, -1, 1, 10, 16, 40)
    return q, c, np.full(10, 16, np.int32), np.full(10, 40, np.int32), 4, 0.5


def _wide_k() -> Case:  # k larger than any row's hit count
    q, c = _uniform(3, -1, 1, 2, 50, 90)
    return q, c, np.array([50, 20], np.int32), np.array([90, 90], np.int32), 64, 0.2


def _full_rows() -> Case:  # dense hits: rows fill and stop early
    q, c = _uniform(4, 0, 0.2, 3, 40, 600)
    return q, c, np.array([40, 17, 33], np.int32), np.array([600, 300, 257], np.int32), 20, 0.05


def _full_rows_tiles() -> Case:
    # batch 0's rows all fill within its first 1024-candidate tile, so its
    # blocks stop with the second tile in flight
    q, c = _uniform(9, 0, 0.2, 3, 300, 2000)
    return (q, c, np.array([300, 129, 255], np.int32), np.array([2000, 700, 257], np.int32),
            20, 0.08)


def _k_mid_step() -> Case:
    # k = 5 reached: on lane 2 of step 0, after lane 0's four hits and with
    # a later hit in the same step (row 0); on lane 31's last candidate,
    # with more on lane 31 before it and on lane 0 of the next step (row 1);
    # on the first candidate of lane 0 of step 2, with two more on that lane
    # (row 2); in the middle of lane 1 of a step holding 7 hits of which 4
    # fit (row 3). Rows 4 and 5 never fill.
    return _planted([[0, 1, 2, 3, 10, 20], list(range(123, 130)),
                     [40, 50, 60, 250, 256, 257, 258], [70, *range(130, 137)], [5, 200], []],
                    s=384, cl=384, k=5)


def _exactly_k() -> Case:
    # k = 6 hits: spread to the last valid index (row 0), all in one step
    # (row 1), the last on lane 31's last candidate (row 2); row 3's sixth
    # lies at index cl
    return _planted([[3, 40, 77, 150, 300, 499], list(range(32, 38)),
                     [100, 110, 120, 125, 126, 127], [200, 210, 220, 230, 240, 500]],
                    s=512, cl=500, k=6)


def _k1() -> Case:
    q, c = _uniform(5, -1, 1, 2, 40, 300)
    return q, c, np.array([40, 31], np.int32), np.array([300, 77], np.int32), 1, 0.3


def _partial_rows() -> Case:  # valid rows not a multiple of a warp's 4 or a block's 16
    q, c = _uniform(6, -1, 1, 4, 70, 120)
    return q, c, np.array([37, 5, 66, 1], np.int32), np.full(4, 120, np.int32), 6, 0.4


def _s_not_mult_4() -> Case:  # the wrapper pads S to a multiple of 4 for the bulk copies
    q, c = _uniform(7, -1, 1, 3, 20, 258)
    return q, c, np.full(3, 20, np.int32), np.array([258, 131, 257], np.int32), 40, 0.5


def _tail_step() -> Case:
    # cl = 1127 is no multiple of 4, of a 128-candidate step or of a
    # 1024-candidate tile: hits in the last, partial step, at and past cl
    # (1127 is the last candidate of a lane whose first three are valid),
    # and across the tile boundary
    return _planted([[1126, 1127, 1200], [0, 1023, 1024, 1120],
                     list(range(1121, 1126)), [1150, 1210]],
                    s=1216, cl=1127, k=4)


def _cl0() -> Case:  # no candidates for rows that exist
    q, c = _uniform(8, -1, 1, 2, 10, 32)
    return q, c, np.array([10, 10], np.int32), np.array([0, 20], np.int32), 3, 0.5


def _multi_tile() -> Case:
    # 9 tiles of 1024 through a ring of 3 buffers; some rows fill part way
    q, c = _uniform(10, 0, 1, 2, 24, 9000)
    return q, c, np.array([24, 19], np.int32), np.array([8999, 5000], np.int32), 8, 0.068


BALL_QUERY_CASES = {
    "ragged": _ragged,
    "scan_order": _scan_order,
    "chunked": _chunked,
    "wide_k": _wide_k,
    "full_rows": _full_rows,
    "full_rows_tiles": _full_rows_tiles,
    "k_mid_step": _k_mid_step,
    "exactly_k": _exactly_k,
    "k1": _k1,
    "partial_rows": _partial_rows,
    "s_not_mult_4": _s_not_mult_4,
    "tail_step": _tail_step,
    "cl0": _cl0,
    "multi_tile": _multi_tile,
}


def ball_query_case(name: str) -> Case:
    """The named case's arrays, made anew."""
    return BALL_QUERY_CASES[name]()
