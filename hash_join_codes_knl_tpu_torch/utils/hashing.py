"""The port's key domain, the multiplicative key scramble, the range
hash and the two-level tier hash.

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

That int64 multiply is a dozen elementwise passes.  The engine's hot
path (the unscramble, CPRA's owner bits and buckets, the check) takes
``ops/scramble.py`` instead, whose CUDA kernel multiplies in uint32 in
one pass; ``mul_u32`` here stays its plain version, and the plain
versions of the other kernels and ``range_hash`` keep calling it.
"""

from __future__ import annotations

import numpy as np
import torch

# int32 bit pattern of 0x80000000: the bias, and the biased null key
BIAS = -(2**31)
_MASK = 0xFFFFFFFF

# second-level factor of the tier hash (odd, independent of any odd
# `factor` a caller passes); the reference draws factors_2 per run
# (phj.cpp:2134-2139), and any odd constant distinct from factor works
DEFAULT_FACTOR2 = 0xC2B2AE3D


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


def np_hashed_key(keys: np.ndarray, factor: int) -> np.ndarray:
    """(keys * factor) mod 2^32 on the host, as numpy uint32."""
    return (np.asarray(keys, dtype=np.uint32) * np.uint32(factor)).astype(
        np.uint32)


def _check_tier_partitions(partitions: int) -> None:
    if partitions % 2:
        raise ValueError(
            f"tier hash needs an even partition count, got {partitions}: "
            "both tiers map into [0, 2*(P//2)), so an odd P would idle "
            "the last partition silently"
        )


def np_hash_ratio(keys: np.ndarray, factor: int, partitions: int,
                  ratio: float, factor2: int | None = None) -> np.ndarray:
    """Host form of hash_ratio, as numpy uint32 partition ids."""
    _check_tier_partitions(partitions)
    if factor2 is None:
        factor2 = DEFAULT_FACTOR2
    cut = np.uint32(int((1.0 - ratio) * 100))
    hk = np_hashed_key(keys, factor).astype(np.uint64)
    hk2 = np_hashed_key(keys, factor2).astype(np.uint64)
    tier = ((hk * np.uint64(100)) >> np.uint64(32)).astype(np.uint32) >= cut
    half = partitions // 2
    pid = ((hk2 * np.uint64(half)) >> np.uint64(32)).astype(np.uint32)
    return np.where(tier, pid + np.uint32(half), pid)


def hash_ratio(keys: torch.Tensor, factor: int, partitions: int,
               ratio: float, factor2: int | None = None) -> torch.Tensor:
    """The two-level tier+partition hash (simd_hash_ratio,
    phj.cpp:101-116) of raw key bits, as int64 partition ids.

    Tier = range_hash(key, factor, 100) against cut = (1-ratio)*100:
    bins below the cut go to tier A (partitions [0, P/2), the
    reference's DDR half), the rest to tier B ([P/2, P)).  The partition
    within the half is a range hash of an independent second scramble
    (factors_2 in the reference): with both levels from one scramble,
    tier and partition are monotone in each other and half of each tier
    receives no traffic."""
    _check_tier_partitions(partitions)
    if factor2 is None:
        factor2 = DEFAULT_FACTOR2
    cut = int((1.0 - ratio) * 100)
    tier_b = range_hash(keys, factor, 100) >= cut
    half = partitions // 2
    pid = range_hash(keys, factor2, half)
    return torch.where(tier_b, pid + half, pid)


def radix_bits(hk: torch.Tensor, hi_bit: int, bits: int) -> torch.Tensor:
    """`bits` bits of the unsigned (unbiased) hk ending just below
    `hi_bit` from the top, as int64: hi_bit=32, bits=6 is the top six
    bits, the next pass hi_bit=26."""
    u = hk.to(torch.int64) & _MASK
    return (u >> (hi_bit - bits)) & ((1 << bits) - 1)
