"""Multi-column joins on the PyTorch/CUDA port: named columns of any
dtype, four join modes, u64 and composite keys -- the engine core stays
(u32, u32) (examples/dataframe_style.py's steps).

python examples/torch_dataframe_style.py [--device cpu]
"""

import argparse
import os
import sys

import numpy as np

# the repository root, so the example runs from a checkout
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import hash_join_codes_knl_tpu_torch as hjk  # noqa: E402
from hash_join_codes_knl_tpu_torch.utils.bench import (  # noqa: E402
    add_device_arg,
    entry_device,
)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_arg(ap)
    dev = entry_device(ap.parse_args().device)
    rng = np.random.default_rng(7)
    n_items, n_sales = 4096, 20000
    item_id = np.unique(rng.integers(1, 2**32, n_items * 2,
                                     dtype=np.uint32))[:n_items]
    items = {
        "price": rng.random(n_items) * 100.0,          # float64
        "category": rng.integers(0, 8, n_items, dtype=np.int8),
    }
    sale_item = item_id[rng.integers(0, n_items, n_sales)].astype(np.uint32)
    # a few sales reference unknown items (exercise left/anti)
    sale_item[: n_sales // 10] = rng.integers(1, 2**32, n_sales // 10,
                                              dtype=np.uint32)
    sales = {
        "qty": rng.integers(1, 9, n_sales, dtype=np.int16),
        "day": rng.integers(0, 365, n_sales, dtype=np.int32),
    }

    # inner: one output row per matching (sale, item) pair
    out, _ = hjk.join_columns(item_id, items, sale_item, sales, device=dev)
    print("inner:", {k: v.dtype.name for k, v in out.items()},
          len(out["qty"]), "rows")

    # left / semi / anti
    left, _ = hjk.join_columns(item_id, items, sale_item, sales,
                               how="left", left_fill=0, device=dev)
    anti, _ = hjk.join_columns(item_id, items, sale_item, sales,
                               how="anti", device=dev)
    print(f"left rows={len(left['qty'])} unknown-item sales="
          f"{len(anti['qty'])}")

    # composite key: join on (category-of-sale, day-bucket) style tuples
    ikc = (items["category"], (item_id & 0xFFFF).astype(np.int32))
    okc = (rng.integers(0, 8, n_sales, dtype=np.int8),
           (sale_item & 0xFFFF).astype(np.int32))
    comp, _ = hjk.join_columns_multi(ikc, items, okc, sales, how="semi",
                                     device=dev)
    print("composite semi rows:", len(comp["qty"]))


if __name__ == "__main__":
    main()
