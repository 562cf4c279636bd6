"""Output compaction: the close_gaps analog (K10, npj.cpp:475-514).

Counterpart of ``hash_join_codes_knl_tpu/ops/compact.py``, which packs
by one stable sort of the negated flag (the TPU has no usable vector
scatter).  Here a prefix sum gives every row its slot and one scatter
places it: the same stable order, flagged rows first.
"""

from __future__ import annotations

import torch


def compact_rows(flags, *columns):
    """Pack rows with flags != 0 to the front, preserving order.

    Returns (count, packed_columns...): count a 0-d int64 tensor; the
    first `count` entries of each packed column are the surviving rows,
    the tail the dropped rows, in order."""
    keep = flags != 0
    ahead = torch.cumsum(keep, 0)
    count = ahead[-1] if keep.numel() else ahead.new_zeros(())
    # dropped row i goes after every kept row and the dropped rows
    # before it: count + (i - kept rows up to i)
    pos = torch.where(keep, ahead - 1,
                      count + torch.arange(keep.numel(), device=keep.device)
                      - ahead)
    packed = []
    for c in columns:
        out = torch.empty_like(c)
        out[pos] = c
        packed.append(out)
    return (count, *packed)
