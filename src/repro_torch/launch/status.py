"""Terminal status view: SLO compliance, burn rates, alerts, replica health.

Renders one human-readable panel from the observability artifacts the rest
of the stack already produces — no new measurement, just presentation:

* a :class:`~repro_torch.obs.MetricsRegistry` snapshot (live object, or a line
  of the ``--metrics-jsonl`` time series),
* :meth:`SLOEvaluator.status` (per-SLO state + per-window burn rates),
* the JSONL alert stream (``--alerts-jsonl``),
* the router's per-replica records.

Used two ways:

* **in-process** — ``launch/serve.py --slo`` prints the final panel via
  :func:`render_status`;
* **offline / follow** —
  ``python -m repro_torch.launch.status --metrics-jsonl serve-metrics.jsonl
  [--alerts-jsonl serve-alerts.jsonl] [--follow]`` renders the newest
  sample of a (possibly still growing) series; ``--follow`` re-renders as
  lines append — a poor man's dashboard over two flat files.  Offline, the
  alert state per SLO is reconstructed from the LAST event in the alert
  stream (the state machine's transitions are total, so its latest
  transition IS its current state).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

_STATE_GLYPH = {"ok": "·", "warn": "▲", "page": "●"}


def _fmt_val(v) -> str:
    if isinstance(v, float):
        if v != v:                       # NaN
            return "-"
        return f"{v:.4g}"
    return str(v)


def _hist_line(name: str, h: dict) -> str:
    return (f"  {name:<38} n={h.get('count', 0):<8} "
            f"p50={h.get('p50_ms', 0.0):>8.3f}ms "
            f"p95={h.get('p95_ms', 0.0):>8.3f}ms "
            f"p99={h.get('p99_ms', 0.0):>8.3f}ms")


def render_status(metrics: dict | None = None, slo_status: dict | None = None,
                  alerts: list | None = None, replicas: list | None = None,
                  title: str = "serving status") -> str:
    """One status panel as a string (caller prints — testable, pipeable)."""
    lines = [f"== {title} =="]
    if slo_status:
        lines.append("-- SLOs --")
        for name, st in sorted(slo_status.items()):
            glyph = _STATE_GLYPH.get(st.get("state", "ok"), "?")
            burns = st.get("burns", {}) or {}
            burn_s = " ".join(
                f"{w}={'-' if b is None else f'{b:.2f}x'}"
                for w, b in sorted(burns.items())) or "-"
            lines.append(
                f"  {glyph} {name:<22} [{st.get('state', '?'):>4}] "
                f"value={_fmt_val(st.get('value')):<10} "
                f"objective={_fmt_val(st.get('objective')):<10} burn {burn_s}")
    if alerts:
        lines.append(f"-- alerts ({len(alerts)} events, newest last) --")
        for ev in alerts[-8:]:
            lines.append(
                f"  {ev.get('severity', '?'):>4} <- {ev.get('previous', '?'):<4} "
                f"{ev.get('slo', '?'):<22} {ev.get('message', '')}")
    if replicas:
        lines.append("-- replicas --")
        for rep in replicas:
            lines.append(
                f"  #{rep.get('id', '?')} {rep.get('state', '?'):<8} "
                f"gen={rep.get('generation', '?')} "
                f"worker_alive={rep.get('worker_alive', '?')} "
                f"consecutive_failures={rep.get('consecutive_failures', 0)}")
    if metrics:
        hists = {k: v for k, v in metrics.items()
                 if isinstance(v, dict) and "p99_ms" in v}
        scalars = {k: v for k, v in metrics.items()
                   if isinstance(v, (int, float))}
        if hists:
            lines.append("-- latency --")
            for k in sorted(hists):
                lines.append(_hist_line(k, hists[k]))
        if scalars:
            lines.append("-- counters / gauges --")
            # freshness + lag + health first: the signals the SLOs watch
            front = [k for k in sorted(scalars)
                     if "generation_age" in k or "lag" in k or "healthy" in k]
            rest = [k for k in sorted(scalars) if k not in front]
            for k in front + rest:
                lines.append(f"  {k:<44} {_fmt_val(scalars[k])}")
    return "\n".join(lines)


def _last_metrics_sample(path: str) -> tuple[float | None, dict | None]:
    last = None
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    last = line
    except OSError:
        return None, None
    if last is None:
        return None, None
    try:
        rec = json.loads(last)
    except json.JSONDecodeError:
        return None, None      # a partially-written tail line: wait for more
    return rec.get("t"), rec.get("metrics")


def _read_alerts(path: str) -> list[dict]:
    events: list[dict] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    events.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
    except OSError:
        pass
    return events


def slo_status_from_alerts(events: list[dict]) -> dict:
    """Reconstruct each SLO's current state from its newest transition —
    the offline stand-in for a live ``SLOEvaluator.status()``."""
    out: dict = {}
    for ev in events:       # in file order: the last event per spec wins
        out[ev.get("slo", "?")] = {
            "state": ev.get("severity", "?"),
            "signal": ev.get("signal", ""),
            "kind": ev.get("kind", ""),
            "value": ev.get("value"),
            "objective": ev.get("objective"),
            "burns": {f"{ev.get('window_s', 0):g}s": ev.get("burn_rate")},
        }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.status",
        description="Render SLO/alert/metrics status from serve's JSONL streams",
    )
    ap.add_argument("--metrics-jsonl", required=True, metavar="FILE",
                    help="registry time series written by serve --metrics-jsonl")
    ap.add_argument("--alerts-jsonl", default="", metavar="FILE",
                    help="alert stream written by serve --slo --alerts-jsonl")
    ap.add_argument("--follow", action="store_true",
                    help="re-render as the series grows (ctrl-c to stop)")
    ap.add_argument("--interval", type=float, default=1.0,
                    help="refresh period with --follow (seconds)")
    args = ap.parse_args(argv)

    def render_once() -> bool:
        t, metrics = _last_metrics_sample(args.metrics_jsonl)
        if metrics is None:
            print(f"[status] no samples in {args.metrics_jsonl} yet",
                  file=sys.stderr)
            return False
        alerts = _read_alerts(args.alerts_jsonl) if args.alerts_jsonl else []
        age = "" if t is None else f" (sample {time.time() - t:.1f}s old)"
        print(render_status(metrics, slo_status_from_alerts(alerts) or None,
                            alerts or None, title=f"serving status{age}"))
        return True

    if not args.follow:
        return 0 if render_once() else 1
    try:
        while True:
            render_once()
            time.sleep(args.interval)
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
