"""Three-term roofline of one H100, with the part read from the card.

  compute term    = operations per rank      / the part's peak rate for their type
  memory term     = HBM bytes per rank       / the part's HBM rate
  collective term = collective bytes per rank / the rate of the link the group uses

The operations and bytes come from ``launch.op_analysis`` (a walk of the
count step on meta tensors) or from a caller's own count; the collective
bytes are the operand bytes of each collective the mesh engine issues, as the
JAX package's dry run counts them.

The rates are NVIDIA's data-sheet figures for the three H100 parts, dense
(without sparsity), at each part's full power limit.  ``chip_smoke.py`` and
the static cost read them from here.  The int32 rate is not on the data
sheet: it is the part's SM count × 64 int32 lanes × its boost clock (half
of the 128 fp32 lanes behind the fp32 figure, which counts an FMA as two).

Links.  Inside a node of :data:`NODE_GPUS` cards the ranks talk over
NVLink: the data sheet's figure counts both directions, so a rank sends at
half of it.  A group whose ranks lie in more than one node (ranks are
numbered node by node) is held to one 400 Gb/s NDR InfiniBand port per GPU,
50 GB/s.  :func:`link_bytes_per_s` says which a group uses.

Importing this module touches no CUDA state: :func:`detect_chip` reads the
card only when called.
"""

from __future__ import annotations

import dataclasses

NODE_GPUS = 8                  # GPUs of one HGX / DGX node, joined by NVLink
NDR_BYTES_PER_S = 400e9 / 8    # one 400 Gb/s NDR port per GPU, across nodes


@dataclasses.dataclass(frozen=True)
class Chip:
    """One H100 part's data-sheet rates (dense, full power limit)."""

    part: str                  # "sxm" | "pcie" | "nvl"
    label: str                 # the data sheet's name for it
    bf16_flop_per_s: float     # tensor cores, fp32 accumulation
    int8_op_per_s: float       # tensor cores, int32 accumulation
    fp32_flop_per_s: float     # CUDA cores, an FMA counted as two
    int32_op_per_s: float      # SMs × 64 lanes × boost clock
    hbm_bytes_per_s: float
    nvlink_bytes_per_s: float  # one direction: half the data sheet's figure
    power_w: float

    def peak(self, dtype: str) -> float:
        """The peak rate for operations on ``dtype`` operands: ``bf16`` and
        ``int8`` on the tensor cores, ``fp32`` and ``int32`` outside them."""
        rates = {"bf16": self.bf16_flop_per_s, "int8": self.int8_op_per_s,
                 "fp32": self.fp32_flop_per_s, "int32": self.int32_op_per_s}
        if dtype not in rates:
            raise ValueError(f"no peak rate for {dtype!r}; one of {sorted(rates)}")
        return rates[dtype]


PARTS = {
    "sxm": Chip("sxm", "H100 SXM5 80GB", 989e12, 1979e12, 67e12, 132 * 64 * 1.98e9,
                3.35e12, 900e9 / 2, 700.0),
    "pcie": Chip("pcie", "H100 PCIe 80GB", 756e12, 1513e12, 51e12, 114 * 64 * 1.755e9,
                 2.0e12, 600e9 / 2, 350.0),
    "nvl": Chip("nvl", "H100 NVL 94GB", 835e12, 1671e12, 60e12, 132 * 64 * 1.785e9,
                3.9e12, 600e9 / 2, 400.0),
}
DEFAULT_PART = "sxm"   # the part a run with no card (the dry run) is costed for


def part_for_name(name: str) -> Chip:
    """The part of a card from its CUDA name (``NVIDIA H100 80GB HBM3`` is
    the SXM part, ``NVIDIA H100 PCIe`` and ``NVIDIA H100 NVL`` the others).
    Any other name raises: there is no default card."""
    if "H100" in name:
        if "PCIe" in name:
            return PARTS["pcie"]
        if "NVL" in name:
            return PARTS["nvl"]
        if "SXM" in name or "HBM3" in name:
            return PARTS["sxm"]
    raise ValueError(f"no roofline for the card {name!r}; name the part "
                     f"(one of {sorted(PARTS)})")


def detect_chip(device="cuda", *, part: str | None = None) -> Chip:
    """The part of the card ``device`` names, from
    ``torch.cuda.get_device_properties``; ``part`` names it instead (and
    then no card is read)."""
    if part is not None:
        if part not in PARTS:
            raise ValueError(f"unknown part {part!r}; one of {sorted(PARTS)}")
        return PARTS[part]
    import torch

    return part_for_name(torch.cuda.get_device_properties(torch.device(device)).name)


def link_bytes_per_s(ranks, chip: Chip | None = None) -> float:
    """The rate a rank of a group over global ``ranks`` sends at: NVLink
    when every rank lies in one node of :data:`NODE_GPUS`, else NDR."""
    chip = chip or PARTS[DEFAULT_PART]
    nodes = {int(r) // NODE_GPUS for r in ranks}
    return chip.nvlink_bytes_per_s if len(nodes) <= 1 else NDR_BYTES_PER_S


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def compute_fraction(self) -> float:
        """How close the step is to pure-compute roofline: compute / bound."""
        return self.compute_s / max(self.bound_s, 1e-30)


def roofline_terms(flops_per_dev: float, hbm_bytes_per_dev: float, coll_bytes_per_dev: float,
                   *, chip: Chip | None = None, dtype: str = "bf16",
                   link_bytes_per_s: float | None = None) -> Roofline:
    """The three terms on ``chip`` (the SXM part by default), the
    operations at the part's ``dtype`` rate and the collective bytes at
    ``link_bytes_per_s`` (NVLink inside one node by default)."""
    chip = chip or PARTS[DEFAULT_PART]
    link = chip.nvlink_bytes_per_s if link_bytes_per_s is None else link_bytes_per_s
    return Roofline(
        compute_s=flops_per_dev / chip.peak(dtype),
        memory_s=hbm_bytes_per_dev / chip.hbm_bytes_per_s,
        collective_s=coll_bytes_per_dev / link,
    )
