"""The key scramble as one uint32 pass: ((x ^ xor_in) * factor) ^ xor_out
mod 2^32, on int32 bit patterns.

No TPU kernel's counterpart: on the TPU the scramble and the unscramble
were uint32 multiplies that XLA fused (``hashed_key``;
``engine/phj.py``'s ``pk * inv`` at the end of every PHJ mode).  torch
has no uint32 multiply, so the plain version widens to int64
(``utils/hashing.mul_u32``), about a dozen elementwise passes over every
slot.  The engine's hot-path callers (the unscramble of every PHJ mode
and of the stream join's chunk replay, CPRA's owner bits and received
buckets, the check's monotonicity pass) take this module on CUDA
tensors; the plain versions of the other kernels keep the int64
function, so a kernel is never held against another kernel.

Kernel: ``csrc/scramble.cu``.  Bound on the H100: memory bandwidth, 4 B
read and 4 B written per slot.
"""

from __future__ import annotations

import torch

from ..utils import hashing
from ..utils.hashing import BIAS, mod_inverse_u32
from . import _build

_MASK = 0xFFFFFFFF


def _i32(v: int) -> int:
    """A 32-bit pattern as the int32 value torch's xor takes."""
    v &= _MASK
    return v - 2**32 if v >= 2**31 else v


def _check(x: torch.Tensor) -> None:
    if x.dtype != torch.int32 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError("x must be a contiguous 1-D int32 tensor")


def mul_u32_torch(x: torch.Tensor, factor: int, xor_in: int = 0,
                  xor_out: int = 0) -> torch.Tensor:
    """Plain version: the int64 multiply of utils/hashing.py with the
    two xors around it."""
    if xor_in & _MASK:
        x = x ^ _i32(xor_in)
    y = hashing.mul_u32(x, factor)
    return y ^ _i32(xor_out) if xor_out & _MASK else y


def mul_u32(x: torch.Tensor, factor: int, xor_in: int = 0,
            xor_out: int = 0) -> torch.Tensor:
    """((x ^ xor_in) * factor) ^ xor_out mod 2^32 of a (n,) int32 bit
    column, as a new int32 column.  A CUDA tensor launches the kernel; a
    CPU tensor takes the plain version."""
    _check(x)
    if x.device.type == "cpu":
        return mul_u32_torch(x, factor, xor_in, xor_out)
    out = torch.empty_like(x)
    _build.launch("hjk_mul_u32", x.device, x, x.shape[0], out,
                  factor & _MASK, xor_in & _MASK, xor_out & _MASK)
    if x.shape[0]:  # the entry point launches nothing for n == 0
        _build.count_launch(mul_u32)
    return out


mul_u32.launches = 0


def unscramble(pk: torch.Tensor, factor: int) -> torch.Tensor:
    """Original keys of a biased scrambled column (pads become 0): the
    unbias and the multiply by factor's inverse in one pass."""
    return mul_u32(pk, mod_inverse_u32(factor), xor_in=BIAS)
