"""Data-sheet rates of the three H100 parts, frozen for the benchmark.

NVIDIA's figures, dense (without sparsity), at each part's full power
limit.  The int32 rate is not on the data sheet: it is the part's SM count
x 64 int32 lanes x its boost clock.  A card may run below its full limit;
every run records the card's ``power.limit`` beside its numbers.
"""

from __future__ import annotations

import subprocess

PARTS = {
    "sxm": dict(label="H100 SXM5 80GB", bf16=989e12, int8=1979e12, fp32=67e12,
                int32=132 * 64 * 1.98e9, hbm=3.35e12, power_w=700.0),
    "pcie": dict(label="H100 PCIe 80GB", bf16=756e12, int8=1513e12, fp32=51e12,
                 int32=114 * 64 * 1.755e9, hbm=2.0e12, power_w=350.0),
    "nvl": dict(label="H100 NVL 94GB", bf16=835e12, int8=1671e12, fp32=60e12,
                int32=132 * 64 * 1.785e9, hbm=3.9e12, power_w=400.0),
}


def part(name: str) -> dict | None:
    """The rates of a card from its CUDA name, or None for a card that is
    not an H100 (whose roofline shares are then not read)."""
    if "H100" not in name:
        return None
    if "PCIe" in name:
        return PARTS["pcie"]
    if "NVL" in name:
        return PARTS["nvl"]
    return PARTS["sxm"]


def power_limit(cards) -> list:
    """``name, power.limit`` of each card of ``cards`` (CUDA indices, which
    are ``nvidia-smi``'s where ``CUDA_VISIBLE_DEVICES`` is unset) as
    ``nvidia-smi`` reads it, or ``not read``."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=index,name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return ["not read" for _ in cards]
    read = {}
    for row in out.stdout.strip().splitlines():
        index, _, rest = row.partition(",")
        read[index.strip()] = rest.strip()
    return [read.get(str(int(c)), "not read") for c in cards]
