"""What the per-layer readers share.  A reader gets the run (the driver's
window result with ``profile``, ``peaks``, ``reference``, ``config`` and
``traffic``) and returns a number, or None where it finds nothing to read.
A roofline share is the least time the work could take (``bench/bounds``)
over the kernel's device time in the traced window, in percent."""

from __future__ import annotations

import math

from bench import bounds

K1_KERNELS = ("candidate_meta_kernel", "bitmap_kernel", "count_kernel")
K2_KERNELS = ("compact_rules_kernel", "rule_match_kernel")
K3_KERNELS = ("support_count_kernel",)
CANDIDATES_PER_PASS = 1 << 16   # the miner's candidate passes (AprioriConfig.max_candidates_per_pass)


def kernel_s(run, names) -> float:
    prof = run.get("profile") or {}
    return sum(s for n, s in prof.get("kernel_s", {}).items() if n in names)


def share(bound_s: float, device_s: float):
    return 100.0 * bound_s / device_s if device_s > 0 and bound_s > 0 else None


def job_share(run, label: str):
    """A wrapped function's seconds over the jobs' wall, in percent."""
    jobs = run.get("jobs") or []
    wall = sum(j["wall_s"] for j in jobs)
    if not wall or not all(label in j.get("clocks", {}) for j in jobs):
        return None
    return 100.0 * sum(j["clocks"][label] for j in jobs) / wall


def phase_share(run, phase: str):
    jobs = run.get("jobs") or []
    wall = sum(j["wall_s"] for j in jobs)
    if not wall or not all("phases" in j for j in jobs):
        return None
    return 100.0 * sum(j["phases"][phase] for j in jobs) / wall


def idle_pct(run):
    prof = run.get("profile") or {}
    if not prof.get("busy_s") or not prof.get("window_s"):
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])


def span_ms(run, name: str):
    spans = (run.get("spans") or {}).get(name)
    return 1e3 * sum(spans) / len(spans) if spans else None


def _levels(run):
    ref = run.get("reference") or {}
    return ref.get("candidates")


def k3_bound_s(run):
    """Every dense pass of every traced job: the real candidates of each
    level against the data set's rows and items."""
    levels, peaks = _levels(run), run.get("peaks")
    if not levels or not peaks or not run.get("jobs"):
        return None
    data = run["config"]["data"]
    per_job = sum(bounds.k3_pass_s(data["num_transactions"], live, data["num_items"], peaks)
                  for c in levels.values() for live in bounds.passes(c, CANDIDATES_PER_PASS))
    return per_job * len(run["jobs"])


def k1_bound_s(run):
    """Every packed chunk launch of every traced job: each level's passes
    over the store's chunks (``chunk_rows`` rows, the last one short)."""
    levels, peaks = _levels(run), run.get("peaks")
    if not levels or not peaks or not run.get("jobs"):
        return None
    data = run["config"]["data"]
    n, chunk = data["num_transactions"], int(run["traffic"]["chunk_rows"])
    words = math.ceil(data["num_items"] / 32)
    chunks = [min(chunk, n - s) for s in range(0, n, chunk)]
    per_job = sum(bounds.k1_launch_s(rows, live, int(k), words, peaks)
                  for k, c in levels.items() for live in bounds.passes(c, CANDIDATES_PER_PASS) for rows in chunks)
    return per_job * len(run["jobs"])


def k2_bound_s(run):
    """Every gateway batch of the traced window, at its mean real rows,
    against the reference rulebook's real rules."""
    ref, peaks = run.get("reference") or {}, run.get("peaks")
    batches = run.get("traced_batches")
    if not peaks or not batches or "rules" not in ref:
        return None
    rows = run["traced_rows"] / batches
    return batches * bounds.k2_launch_s(rows, ref["rules"], ref["ante_words"], ref["words"], peaks)


def batch_rows(run):
    batches = run.get("traced_batches")
    return run["traced_rows"] / batches if batches else None
