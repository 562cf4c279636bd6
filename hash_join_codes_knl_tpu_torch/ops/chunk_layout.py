"""K1: the fused scramble + bias + pad pass into the sort's input buffer.

Counterpart of ``hash_join_codes_knl_tpu/ops/chunk_layout.py``
(``flat_to_rows``, body ``_copy_kernel``).  On the TPU the flat (cap,)
-> (C, cap/C) move was a physical retiling and needed a kernel; on CUDA
a row-major reshape is a view.  What is left of the TPU kernel, together
with the ``hashed_key`` and ``_pad_pair`` passes around it on the JAX
path (engine/phj.py ``_merge_sort_probe``), is one elementwise pass:
slot i < n becomes (bias(key * factor mod 2^32), val), slot i >= n the
null pad (INT32_MIN, 0).  The same pass feeds the build sort (chunks=1).

Kernel: ``csrc/chunk_layout.cu``.  Bound on the H100: memory bandwidth,
8 B read and 8 B written per slot; a grid-stride loop of coalesced
4-byte accesses and nothing else.
"""

from __future__ import annotations

import torch

from ..utils.hashing import BIAS, mul_u32
from . import _build


def _check(keys: torch.Tensor, vals: torch.Tensor, cap: int,
           chunks: int) -> None:
    for name, t in (("keys", keys), ("vals", vals)):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int32 tensor")
    if keys.shape != vals.shape or keys.device != vals.device:
        raise ValueError("keys and vals must share shape and device")
    if cap < keys.shape[0] or chunks < 1 or cap % chunks:
        raise ValueError(
            f"need n <= cap and chunks | cap (n={keys.shape[0]}, cap={cap}, "
            f"chunks={chunks})"
        )


def flat_to_rows_torch(keys: torch.Tensor, vals: torch.Tensor, cap: int,
                       chunks: int = 1, factor: int = 1):
    """Plain version: scramble in int64, bias, zero-pad, view."""
    n = keys.shape[0]
    hk = torch.full((cap,), BIAS, dtype=torch.int32, device=keys.device)
    hk[:n] = mul_u32(keys, factor) ^ BIAS
    v = torch.zeros(cap, dtype=torch.int32, device=vals.device)
    v[:n] = vals
    return hk.view(chunks, -1), v.view(chunks, -1)


def flat_to_rows(keys: torch.Tensor, vals: torch.Tensor, cap: int,
                 chunks: int = 1, factor: int = 1):
    """(n,) key and value columns (int32 bits) -> two (chunks,
    cap/chunks) int32 tensors: the biased scrambled keys
    bias(key * factor mod 2^32) and the values, null-padded from slot n.
    A CUDA tensor launches the kernel; a CPU tensor takes the plain
    version."""
    _check(keys, vals, cap, chunks)
    if keys.device.type == "cpu":
        return flat_to_rows_torch(keys, vals, cap, chunks, factor)
    hk = torch.empty(cap, dtype=torch.int32, device=keys.device)
    v = torch.empty(cap, dtype=torch.int32, device=keys.device)
    _build.launch("hjk_flat_to_rows", keys.device, keys, vals,
                  keys.shape[0], hk, v, cap, factor & 0xFFFFFFFF)
    _build.count_launch(flat_to_rows)
    return hk.view(chunks, -1), v.view(chunks, -1)


flat_to_rows.launches = 0
