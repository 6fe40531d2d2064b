"""Exact counting contractions of {0, 1} operands (``ops/counting.py:57-109``).

The JAX package contracts bf16 operands into an f32 accumulator, or s8 into
s32 (``count_dtype``), and both encodings give identical results. In torch,
``bf16 @ bf16`` returns bf16, which rounds every count above 256, and CUDA
has no general int8/int32 matmul. So the port contracts both encodings as
float32 products of {0, 1} (or small-integer) operands: every partial sum is
an integer below 2**24, which float32 holds exactly, TF32 or not (0 and 1
are exact in TF32's mantissa and the accumulation is float32). The
``count_dtype`` then only picks the accumulator dtype handed back when the
caller asks for it (``out_dtype=None``): float32 for ``"bf16"``, int32 for
``"int8"``, as in the JAX package.
"""

from __future__ import annotations

import torch

from maskclustering_tpu_torch.config import COUNT_DTYPES

_ACCUMULATOR = {"bf16": torch.float32, "int8": torch.int32}


def accumulator_dtype(count_dtype: str) -> torch.dtype:
    """The exact accumulator dtype paired with ``count_dtype`` operands."""
    try:
        return _ACCUMULATOR[count_dtype]
    except KeyError:
        raise ValueError(f"unknown count_dtype {count_dtype!r}; valid: {COUNT_DTYPES}") from None


def count_dot(a: torch.Tensor, b: torch.Tensor, *, count_dtype: str = "bf16",
              out_dtype=torch.float32) -> torch.Tensor:
    """``a @ b`` for small non-negative integer operands, exact.

    ``out_dtype=None`` keeps the encoding's accumulator dtype.
    """
    acc = accumulator_dtype(count_dtype)
    if a.shape[-1] >= 2**24:
        raise ValueError("count_dot: contraction too deep for exact float32 counts")
    out = torch.matmul(a.to(torch.float32), b.to(torch.float32))
    return out.to(acc if out_dtype is None else out_dtype)
