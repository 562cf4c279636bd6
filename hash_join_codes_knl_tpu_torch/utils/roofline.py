"""Roofline accounting: achieved bandwidth against the card's memory
rate.

Counterpart of ``hash_join_codes_knl_tpu/utils/roofline.py``.  Per
phase of the staged merge pipeline, the CLI reports:

- the phase's modeled minimum device-memory traffic (bytes any
  implementation of that phase must move at least once),
- achieved bytes/s against wall time,
- the fraction of the card's peak memory rate that represents.

Traffic model for the merge-mode PHJ pipeline (engine/phj.py), the JAX
package's unchanged:

- partition (sort) of each side: one read and one write of its (key,
  val) stream;
- windows: the tile bounds and the build directory;
- probe: reads the sorted probe keys, writes (match_val, match_cnt), and
  streams each tile's build window once.
"""

from __future__ import annotations

import torch

# peak device-memory rate of one H100 SXM (NVIDIA's data sheet)
H100_SXM_BYTES_PER_S = 3.35e12
# peak memory rate by the name torch.cuda.get_device_name() gives
_HBM_PEAK = {
    "NVIDIA H100 80GB HBM3": H100_SXM_BYTES_PER_S,
}
_CPU_NOMINAL = 50e9


def hbm_peak_bytes_per_s(device=None) -> tuple[float, str]:
    """(peak memory rate of `device`, the matched table entry).  The
    default device is the card when there is one, else the CPU.  The CPU
    gets a nominal figure, labelled so; a card the table does not name
    gets the H100 SXM's figure with an 'assumed:' label, so the report
    shows that the peak is a guess rather than silently mislabelling
    fractions."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return _CPU_NOMINAL, "cpu (nominal DDR)"
    name = torch.cuda.get_device_name(device)
    if name in _HBM_PEAK:
        return _HBM_PEAK[name], name
    return (H100_SXM_BYTES_PER_S,
            f"assumed: the H100 SXM's peak for {name!r}")


def merge_phj_traffic(ni: int, no: int, tile: int, window: int) -> dict:
    """Per-phase minimum device-memory bytes for the merge-mode PHJ
    pipeline, keyed by the staged phase names (engine/phj.py
    phj_join_merge_staged)."""
    n_tiles = -(-no // tile)
    return {
        "partition_build": 2 * 8 * ni,  # r+w of (key,val) once
        "partition_probe": 2 * 8 * no,
        "windows": 4 * (2 * n_tiles + ni // 128),  # tile bounds + directory
        "probe": 4 * no + 8 * no + 8 * window * n_tiles,
    }


def roofline_report(phase_seconds: dict, traffic: dict,
                    device=None) -> dict:
    """Achieved bytes/s and roofline fraction per phase and overall."""
    peak, matched = hbm_peak_bytes_per_s(device)
    out = {"hbm_peak_gbps": round(peak / 1e9, 1),
           "hbm_peak_source": matched}
    tot_b = tot_s = 0.0
    for phase, sec in phase_seconds.items():
        b = traffic.get(phase)
        if b is None or sec <= 0:
            continue
        tot_b += b
        tot_s += sec
        out[f"{phase}_gbps"] = round(b / sec / 1e9, 2)
        out[f"{phase}_pct_roofline"] = round(100 * b / sec / peak, 2)
    if tot_s > 0:
        out["pipeline_pct_roofline"] = round(100 * tot_b / tot_s / peak, 2)
    return out
