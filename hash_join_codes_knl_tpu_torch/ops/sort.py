"""Sort-by-key operator (the JAX package's ``ops/sort.py``)."""

from __future__ import annotations

import torch

from ..utils.hashing import bias


def sort_relation(keys, *payloads):
    """Sort rows ascending by unsigned key (int32 bit tensors), stably;
    payload columns permuted along."""
    order = torch.sort(bias(keys), stable=True).indices
    return (keys[order], *(p[order] for p in payloads))
