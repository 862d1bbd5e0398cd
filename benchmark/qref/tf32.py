"""The control's precision: TF32, the tensor cores' float32 format (8
exponent bits, 10 mantissa bits), applied to both operands of every
product that an fp32-exact path computes exactly."""

from __future__ import annotations

import torch


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (real or complex) rounded to TF32, nearest, as a tensor core
    converts its operands; returned in ``t``'s dtype."""
    if t.is_complex():
        return torch.complex(round_tf32(t.real), round_tf32(t.imag))
    bits = t.to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32).to(t.dtype)
