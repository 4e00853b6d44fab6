"""What each rank of a spawned mesh measured about itself, and the merge
of those records into the run's one device report.

A driver whose window runs on ranks of their own
(``repro_torch.launch.mesh.spawn``) cannot be seen by the harness's
process: neither its card, its memory peak, its trace nor its imports.  So
each rank keeps a record of its own:

    probe = ranks.start(ctx.trace, mesh.device)   # at the rank's window start
    ...                                           # the rank's window
    probe.stop()                                  # at its end (optional)
    return probe.report()                         # one picklable dict

and the driver hands the ranks' records back as ``result["devices"]``, one
a rank in rank order.  :func:`merge` turns them into the line's device
report and, in a traced run, the profile the per-layer readers read.
"""

from __future__ import annotations

import sys

from bench.trace import TOP, DeviceTrace

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """The forbidden top-level names this process has loaded, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Probe:
    """One rank's card, its memory peak over the window and, in a traced
    run, its own ``DeviceTrace``."""

    def __init__(self, trace: bool, device="cuda"):
        import torch

        dev = torch.device(device)
        self.cuda = dev.type == "cuda"
        self.index = (dev.index if dev.index is not None else torch.cuda.current_device()) if self.cuda else None
        self.peak = None
        self.trace = None
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.index)
        if trace:
            self.trace = DeviceTrace()
            self.trace.start()

    def stop(self) -> None:
        """The end of the rank's window: the trace stops and the peak is
        read.  Later calls do nothing."""
        if self.peak is not None:
            return
        if self.trace is not None:
            self.trace.stop()
        if self.cuda:
            import torch

            self.peak = int(torch.cuda.max_memory_allocated(self.index))
        else:
            self.peak = 0

    def report(self) -> dict:
        """The rank's record (stopping the probe first if need be)."""
        self.stop()
        if self.cuda:
            import torch

            props = torch.cuda.get_device_properties(self.index)
            card = dict(uuid=str(props.uuid), index=self.index, kind=torch.cuda.get_device_name(self.index))
        else:
            card = dict(uuid="cpu", index=None, kind="cpu")
        record = dict(card, memory_peak_bytes=self.peak, forbidden=forbidden_modules())
        if self.trace is not None:
            record["profile"] = self.trace.summary()
        return record


def start(trace: bool, device="cuda") -> Probe:
    """A rank's probe, started at its window start on ``device`` (a CUDA
    device without an index is the rank's current card)."""
    return Probe(trace, device)


def merge(records: list, trace: bool) -> dict:
    """The ranks' records as one report: ``kind``, ``count`` (distinct
    cards by UUID, so ranks that share a card count once),
    ``memory_peak_bytes`` (the fullest card's: the sum of its ranks'
    peaks, since their memory sits on it side by side), ``forbidden`` (what
    any rank loaded) and ``ranks`` (each rank's card and peak); in a traced
    run also ``profile``, the ranks' traces merged (:func:`merge_profiles`).
    Cards of different kinds raise ``ValueError``."""
    if not records:
        raise ValueError("the run's driver reported no ranks")
    kinds = sorted({r["kind"] for r in records})
    if len(kinds) != 1:
        raise ValueError(f"the ranks ran on cards of different kinds: {', '.join(kinds)}")
    card_peak: dict = {}
    for r in records:
        card_peak[r["uuid"]] = card_peak.get(r["uuid"], 0) + int(r["memory_peak_bytes"])
    out = dict(kind=kinds[0], count=len(card_peak), memory_peak_bytes=max(card_peak.values()),
               forbidden=sorted({m for r in records for m in r["forbidden"]}),
               ranks=[dict(rank=i, uuid=r["uuid"], index=r["index"], memory_peak_bytes=r["memory_peak_bytes"])
                      for i, r in enumerate(records)])
    if trace:
        out["profile"] = merge_profiles(records)
    return out


def merge_profiles(records: list) -> dict:
    """The ranks' ``DeviceTrace`` summaries as one profile:

    * ``busy_s``: the mean over cards of each card's busy seconds, a card's
      being the sum of its ranks' (the contexts of one card take turns on
      it, so their kernels do not overlap);
    * ``window_s``: the longest rank window;
    * ``kernel_s``, ``device_ops``: summed over every rank, so a roofline
      reader divides one bound by all the cards' kernel seconds;
    * ``idle_gaps``: the longest gaps of all ranks, each named ``rank <r>: ``
      and the host's activity;
    * ``per_device``: each rank's summary with its rank, card UUID and index.
    """
    missing = [i for i, r in enumerate(records) if "profile" not in r]
    if missing:
        raise ValueError(f"a traced run whose rank(s) {missing} reported no trace")
    card_busy: dict = {}
    kernel_s: dict = {}
    op_s: dict = {}
    gaps = []
    for i, r in enumerate(records):
        prof = r["profile"]
        card_busy[r["uuid"]] = card_busy.get(r["uuid"], 0.0) + float(prof["busy_s"])
        for name, s in prof["kernel_s"].items():
            kernel_s[name] = kernel_s.get(name, 0.0) + s
        for name, s in prof["device_ops"]:
            op_s[name] = op_s.get(name, 0.0) + s
        gaps += [[f"rank {i}: {name}", s] for name, s in prof["idle_gaps"]]
    return dict(busy_s=sum(card_busy.values()) / len(card_busy),
                window_s=max(float(r["profile"]["window_s"]) for r in records),
                kernel_s=kernel_s,
                device_ops=[[k, v] for k, v in sorted(op_s.items(), key=lambda kv: -kv[1])[:TOP]],
                idle_gaps=sorted(gaps, key=lambda g: -g[1])[:TOP],
                per_device=[dict(r["profile"], rank=i, uuid=r["uuid"], index=r["index"])
                            for i, r in enumerate(records)])
