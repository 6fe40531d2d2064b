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


def count_dot_general(a: torch.Tensor, b: torch.Tensor, dimension_numbers, *,
                      count_dtype: str = "bf16", out_dtype=torch.float32) -> torch.Tensor:
    """``lax.dot_general`` form of :func:`count_dot`: contract
    ``((lhs_contract, rhs_contract), (lhs_batch, rhs_batch))``, output axes
    ordered batch, lhs free, rhs free, as in JAX."""
    (lc, rc), (lb, rb) = dimension_numbers
    acc = accumulator_dtype(count_dtype)
    letters = iter("abcdefghijklmnopqrstuvwxyz")
    la = [next(letters) for _ in range(a.dim())]
    lb_ = [next(letters) for _ in range(b.dim())]
    for i, j in zip(lc, rc):
        lb_[j] = la[i]
    for i, j in zip(lb, rb):
        lb_[j] = la[i]
    depth = 1
    for i in lc:
        depth *= a.shape[i]
    if depth >= 2**24:
        raise ValueError("count_dot_general: contraction too deep for exact float32 counts")
    out = ([la[i] for i in lb] + [la[i] for i in range(a.dim()) if i not in lc and i not in lb]
           + [lb_[j] for j in range(b.dim()) if j not in rc and j not in rb])
    spec = f"{''.join(la)},{''.join(lb_)}->{''.join(out)}"
    res = torch.einsum(spec, a.to(torch.float32), b.to(torch.float32))
    return res.to(acc if out_dtype is None else out_dtype)


def count_onehot(ids: torch.Tensor, num: int, *, axis: int = -1) -> torch.Tensor:
    """``jax.nn.one_hot`` as float32 {0, 1}: out-of-range ids (negative
    sentinels, padded slots) give all-zero rows; the class axis sits at
    ``axis`` of the output."""
    oh = (ids.unsqueeze(-1) == torch.arange(num, device=ids.device, dtype=ids.dtype))
    return torch.movedim(oh.to(torch.float32), -1, axis)
