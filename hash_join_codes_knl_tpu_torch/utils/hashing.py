"""The port's key domain, the multiplicative key scramble and the range
hash.

Counterpart of ``hash_join_codes_knl_tpu/utils/hashing.py``.  torch has
no complete unsigned 32-bit type (``searchsorted``, ``max`` and ``>>``
refuse ``torch.uint32``), so the port settles one domain here and uses
it everywhere:

- every uint32 column lives in an ``int32`` tensor holding its bits;
- a SORTED or COMPARED key is biased, ``hk ^ 0x80000000`` read as
  ``int32``.  The bias maps unsigned order onto signed order, so the
  null key 0 becomes ``INT32_MIN`` and null pads still sort first;
- arithmetic that needs more than 32 bits happens in ``int64`` and is
  masked back (``mul_u32``), never in overflowing ``int32``.
"""

from __future__ import annotations

import numpy as np
import torch

# int32 bit pattern of 0x80000000: the bias, and the biased null key
BIAS = -(2**31)
_MASK = 0xFFFFFFFF


def mod_inverse_u32(factor: int) -> int:
    """Inverse of an odd factor mod 2^32: key * factor is a bijection on
    u32, so the engine carries scrambled keys through sort and probe and
    recovers the originals with one multiply (hk * inverse == key)."""
    if not factor & 1:
        raise ValueError(f"factor must be odd, got {factor:#x}")
    inv = 1
    for _ in range(5):  # Newton iteration doubles the correct bits: 1 -> 32
        inv = (inv * (2 - factor * inv)) & _MASK
    return inv


def u32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same 32 bits."""
    return ((x ^ 0x80000000) - 0x80000000).to(torch.int32)


def mul_u32(x: torch.Tensor, factor: int) -> torch.Tensor:
    """(x * factor) mod 2^32 on int32 bit patterns.  The product is split
    into 16-bit halves of the factor so that no int64 intermediate
    overflows."""
    f = factor & _MASK
    x64 = x.to(torch.int64) & _MASK
    lo = x64 * (f & 0xFFFF)
    hi = ((x64 * (f >> 16)) & 0xFFFF) << 16
    return u32_to_i32((lo + hi) & _MASK)


def hashed_key(keys: torch.Tensor, factor: int) -> torch.Tensor:
    """uint32(key * factor): the scrambled key, as int32 bits (unbiased)."""
    return mul_u32(keys, factor)


def range_hash(keys: torch.Tensor, factor: int, nbins: int) -> torch.Tensor:
    """The reference's range hash, ((key * factor mod 2^32) * nbins) >>
    32, as int64 bins in [0, nbins), for any nbins < 2^32.  nbins is
    split into 16-bit halves so that no int64 product overflows:
    floor((h * (n1 * 2^16 + n0)) / 2^32) == (h * n1 + ((h * n0) >> 16))
    >> 16."""
    if not 0 < nbins < 2**32:
        raise ValueError(f"nbins must lie in [1, 2^32), got {nbins}")
    h = mul_u32(keys, factor).to(torch.int64) & _MASK
    return (h * (nbins >> 16) + ((h * (nbins & 0xFFFF)) >> 16)) >> 16


def bias(x: torch.Tensor) -> torch.Tensor:
    """Flip bit 31 of int32 bits: unsigned order becomes signed order.
    The bias is its own inverse, so it also un-biases."""
    return x ^ BIAS


unbias = bias


def u32_to_device(a: np.ndarray, device) -> torch.Tensor:
    """numpy uint32 column -> int32 tensor holding the same bits on
    `device`."""
    a = np.ascontiguousarray(a, dtype=np.uint32)
    return torch.from_numpy(a.view(np.int32)).to(device)


def to_numpy_u32(t: torch.Tensor) -> np.ndarray:
    """int32-bit tensor -> host numpy uint32 array with the same bits."""
    if t.dtype != torch.int32:
        raise TypeError(f"expected an int32 bit tensor, got {t.dtype}")
    return t.detach().cpu().numpy().view(np.uint32)
