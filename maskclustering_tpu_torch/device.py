"""The port's device rule: CUDA unless the caller names another device."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the current CUDA device; raises when no card is present.

    The port never drops to the CPU on its own: a caller that wants the CPU
    (the tests) asks for it with ``device="cpu"``.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain torch path on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def synchronize(device: Optional[torch.device]) -> None:
    """Wait for queued device work (a no-op on the CPU), so host wall
    clocks around a stage measure the stage and not its enqueue."""
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


def check_full_float32(device: torch.device, user: str) -> None:
    """Refuse a CUDA device on which this process lets float32 products
    round to TF32: a reduced-precision product (an argmax between close
    labels, a feature) is a different result, not a faster one."""
    if device.type == "cuda" and (torch.backends.cuda.matmul.allow_tf32
                                  or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(f"{user} needs full float32 matmuls; this process allows TF32 "
                           f"(torch.backends.cuda.matmul.allow_tf32 / "
                           f"set_float32_matmul_precision)")
