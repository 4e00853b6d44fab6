"""Bench-trajectory regression gate: one uniform check over BENCH_*.json (§14).

The committed trajectory files (``BENCH_serve.json`` / ``BENCH_fault.json``
/ ``BENCH_obs.json``) accumulate one row per benchmark, merge-by-name
across runs, each row carrying a bounded ``history`` of its prior
``us_per_call`` values.  CI used to spot-check a handful of rows with
hand-coded jq thresholds; this module replaces those with one detector run
as ``python -m repro_torch.obs.regress --check BENCH_*.json``.

Two checks per row:

* **Trajectory** (noise-aware): the latest ``us_per_call`` is compared to
  the trajectory baseline — the **median** of the row's history (median,
  not mean: one historic outlier run must not poison the baseline).  The
  tolerance is ``max(rel_floor, noise_k * MAD / baseline)`` where MAD is
  the history's median absolute deviation — a row that historically
  jitters ±20% gets a proportionally wider gate than a row that repeats to
  1%, so noisy benches don't cry wolf and stable benches stay tight.  Only
  DEGRADATION (latest slower than baseline by more than the tolerance) is
  flagged; getting faster just becomes the new history.  Rows with fewer
  than ``min_history`` prior values pass vacuously — a young trajectory
  has no baseline to regress from.  "Factors Affecting Performance of
  MapReduce based Apriori" (1701.05982) is the motivation: cluster-Apriori
  throughput swings heavily with configuration drift, exactly what a
  trajectory baseline catches and a fixed threshold misses.

* **Invariant** (semantic): the correctness/efficiency claims the old
  per-row CI gates asserted, now declarative: micro-batching must still
  beat sequential, the replicated tier must still scale and survive the
  kill with ≥ 99% availability, checkpoint/instrumentation overhead must
  stay bounded with parity intact, and the adaptive-wait controller must
  move p99 TOWARD the objective.  A row named by an invariant that is
  missing from every checked file fails by default — a silently-dropped
  bench must not read as green.  Any row with ``us_per_call < 0`` (the
  harness's FAILED marker) fails unconditionally.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
from typing import Dict, List, Optional, Sequence, Tuple

#: Declarative replacements for the retired hand-coded CI gates:
#: row name -> list of (derived key, operator, expected) triples.
#: Operators: ">=", "<=" compare numerically (trailing unit suffixes like
#: "x" / "%" are stripped); "==" compares numerically when both sides
#: parse, else as strings ("parity=ok").
INVARIANTS: Dict[str, List[Tuple[str, str, object]]] = {
    # gateway micro-batching must beat sequential serving (§10 gate)
    "serve_gateway_microbatch_c32": [("speedup_vs_sequential", ">=", 2.0)],
    # 2 replicas must partition the cache working set into real scaling (§12)
    "serve_replicated_r2": [("scaling_vs_r1", ">=", 1.5)],
    # mid-load replica kill: supervised restart + failover keep availability
    "serve_replicated_kill_recovery": [
        ("availability", ">=", 0.99),
        ("kills_fired", "==", 1),
        ("restarts", ">=", 1),
    ],
    # checkpointing the streamed mine stays cheap (§11 gate)
    "fault_mine_chk_n60000": [("overhead_vs_unchk", "<=", 1.10)],
    # kill+resume reproduces the uninterrupted result, replaying <= 1 level
    "fault_kill_resume_n60000": [
        ("parity", "==", "ok"),
        ("replayed_levels", "<=", 1),
    ],
    # incremental refresh (§15): folding a 1% append through the count cache
    # must stay dict-identical to the full re-mine AND well ahead of it
    "fault_refresh_delta_p1": [
        ("parity", "==", "ok"),
        ("mode", "==", "delta"),
        ("speedup_vs_full", ">=", 3.0),
    ],
    # full instrumentation is near-free and provably inert (§13 gate)
    "obs_mine_instrumented_n60000": [
        ("overhead_vs_plain", "<=", 1.05),
        ("parity", "==", "ok"),
    ],
    # the adaptive-wait controller moves p99 toward the objective (§14 gate)
    "obs_slo_adaptive_wait": [("toward_objective", "==", "yes")],
}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One check outcome (ok or violation) for the report."""

    file: str
    row: str
    check: str          # trajectory | invariant | failed_row | missing_row
    ok: bool
    detail: str

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def parse_derived(derived: str) -> Dict[str, str]:
    """``key=value;key=value`` pairs from a bench row's derived string;
    fragments without ``=`` (e.g. ``correctness_path``) are skipped."""
    out: Dict[str, str] = {}
    for frag in (derived or "").split(";"):
        if "=" in frag:
            k, v = frag.split("=", 1)
            out[k.strip()] = v.strip()
    return out


def _num(v: object) -> Optional[float]:
    """Float from a derived value, tolerating unit suffixes (``1.05x``,
    ``80%_of_gap`` does NOT parse — only a trailing x/% on a clean number)."""
    if isinstance(v, (int, float)):
        return float(v)
    s = str(v).strip()
    for suffix in ("x", "%"):
        if s.endswith(suffix):
            s = s[: -len(suffix)]
    try:
        return float(s)
    except ValueError:
        return None


def _check_invariant(key: str, op: str, expected, derived: Dict[str, str]) -> Tuple[bool, str]:
    if key not in derived:
        return False, f"derived key {key!r} missing"
    actual = derived[key]
    a_num, e_num = _num(actual), _num(expected)
    if op == ">=":
        ok = a_num is not None and e_num is not None and a_num >= e_num
    elif op == "<=":
        ok = a_num is not None and e_num is not None and a_num <= e_num
    elif op == "==":
        if a_num is not None and e_num is not None:
            ok = a_num == e_num
        else:
            ok = str(actual) == str(expected)
    else:  # pragma: no cover — INVARIANTS is static
        raise ValueError(f"unknown invariant operator {op!r}")
    return ok, f"{key}={actual} (want {op} {expected})"


def check_trajectory(
    name: str,
    latest_us: float,
    history: Sequence[float],
    *,
    min_history: int = 3,
    rel_floor: float = 0.30,
    noise_k: float = 4.0,
) -> Tuple[bool, str]:
    """Noise-aware degradation check for one row. Returns (ok, detail)."""
    hist = [h for h in history if isinstance(h, (int, float)) and h >= 0]
    if len(hist) < min_history:
        return True, (f"history={len(hist)} < {min_history}: no baseline yet, "
                      f"pass vacuously")
    baseline = statistics.median(hist)
    if baseline <= 0:
        return True, "non-positive baseline: skipped"
    mad = statistics.median(abs(h - baseline) for h in hist)
    tol = max(rel_floor, noise_k * mad / baseline)
    limit = baseline * (1.0 + tol)
    ok = latest_us <= limit
    return ok, (f"latest={latest_us:.1f}us baseline={baseline:.1f}us "
                f"tol={tol:.0%} limit={limit:.1f}us (n={len(hist)})")


def check_files(
    paths: Sequence[str],
    *,
    min_history: int = 3,
    rel_floor: float = 0.30,
    noise_k: float = 4.0,
    invariants: Optional[Dict[str, List[Tuple[str, str, object]]]] = None,
) -> Tuple[bool, List[Finding]]:
    """Run both checks over every row of every file; invariants resolve
    against the UNION of rows (a gate row may live in any of the files).
    Returns (all ok, findings — violations first)."""
    if invariants is None:
        invariants = INVARIANTS
    findings: List[Finding] = []
    seen_rows: Dict[str, Tuple[str, dict]] = {}
    for path in paths:
        try:
            with open(path) as f:
                rows = json.load(f).get("rows", [])
        except (OSError, json.JSONDecodeError) as e:
            findings.append(Finding(path, "-", "failed_row", False,
                                    f"unreadable trajectory file: {e}"))
            continue
        for r in rows:
            name = r.get("name", "?")
            seen_rows[name] = (path, r)
            us = r.get("us_per_call")
            if not isinstance(us, (int, float)) or us < 0:
                findings.append(Finding(path, name, "failed_row", False,
                                        f"us_per_call={us!r} marks a FAILED bench"))
                continue
            ok, detail = check_trajectory(
                name, float(us), r.get("history", ()),
                min_history=min_history, rel_floor=rel_floor, noise_k=noise_k,
            )
            findings.append(Finding(path, name, "trajectory", ok, detail))
    for name, checks in invariants.items():
        loc = seen_rows.get(name)
        if loc is None:
            findings.append(Finding("-", name, "missing_row", False,
                                    "invariant-gated row missing from every "
                                    "checked trajectory"))
            continue
        path, r = loc
        derived = parse_derived(r.get("derived", ""))
        for key, op, expected in checks:
            ok, detail = _check_invariant(key, op, expected, derived)
            findings.append(Finding(path, name, "invariant", ok, detail))
    findings.sort(key=lambda f: (f.ok, f.file, f.row))
    return all(f.ok for f in findings), findings


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.regress",
        description="Uniform bench-trajectory regression gate over BENCH_*.json",
    )
    ap.add_argument("--check", nargs="+", metavar="FILE", required=True,
                    help="trajectory files to gate (e.g. BENCH_serve.json)")
    ap.add_argument("--min-history", type=int, default=3,
                    help="prior runs required before the trajectory gate arms")
    ap.add_argument("--rel-floor", type=float, default=0.30,
                    help="minimum relative degradation tolerance")
    ap.add_argument("--noise-k", type=float, default=4.0,
                    help="tolerance multiplier on history MAD/baseline")
    ap.add_argument("--json", action="store_true",
                    help="emit findings as JSON instead of text")
    args = ap.parse_args(argv)
    ok, findings = check_files(
        args.check, min_history=args.min_history,
        rel_floor=args.rel_floor, noise_k=args.noise_k,
    )
    if args.json:
        print(json.dumps({"ok": ok, "findings": [f.to_json() for f in findings]},
                         indent=2))
    else:
        for f in findings:
            mark = "ok  " if f.ok else "FAIL"
            print(f"{mark} [{f.check:>10}] {f.row:<36} {f.detail}  ({f.file})")
        n_bad = sum(1 for f in findings if not f.ok)
        print(f"# {len(findings)} checks, {n_bad} violations -> "
              f"{'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
