"""Operand roundings of the reference: the configurations' own (fp32: none;
bf16) and the controls' (TF32 for the fp32 configuration's products, fp8
e4m3 for the bf16 configuration's, bf16 for the fp32 elementwise stages),
each a function of a float32 tensor to a float32 tensor."""

from __future__ import annotations

import torch

FP8_MAX = 448.0   # the largest finite float8 e4m3fn


def fp32(t: torch.Tensor) -> torch.Tensor:
    return t


def bf16(t: torch.Tensor) -> torch.Tensor:
    """To nearest bfloat16, ties to even."""
    return t.to(torch.bfloat16).to(t.dtype)


def tf32(t: torch.Tensor) -> torch.Tensor:
    """To nearest TF32 (10 mantissa bits), ties to even, as the tensor
    cores round a float32 operand."""
    i = t.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    return ((i + 0xFFF + lsb) & ~0x1FFF).view(torch.float32).reshape(t.shape)


def fp8(t: torch.Tensor) -> torch.Tensor:
    """To nearest float8 e4m3fn, saturating at its largest finite value."""
    return t.clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn).to(t.dtype)


ROUNDINGS = {"fp32": fp32, "bf16": bf16, "tf32": tf32, "fp8": fp8}
