"""SLO engine: declarative objectives, burn-rate alerting, alert stream (§14).

The observability layer (§13) gives the system *measurements* — a :class:`MetricsRegistry` full of
counters, gauges and latency histograms — but no *objectives*: nothing said
how slow is too slow, how stale is too stale, or when someone (or some
control loop) should act.  This module closes that gap, SRE-workbook style:

* :class:`SLOSpec` declares one objective over registry metrics.  Four
  kinds cover the serving + mining surface:

  - ``latency``      — "``target_ratio`` of requests complete under
    ``threshold_s``", read from a histogram's bucket counts.  A request in a
    bucket whose upper edge exceeds the threshold counts as an error — the
    same conservative bucket-upper-edge bias the registry quantiles use, so
    the SLO can over-fire a hair but never under-fire.
  - ``error_ratio``  — classic availability: ``bad`` counters over
    ``bad + good`` counters (e.g. failed+shed over completed+failed+shed).
  - ``gauge_bound``  — a bound on a live gauge: rulebook freshness
    (``generation_age_seconds`` > bound is an error sample), replica-set
    health (``healthy_replica_ratio`` < bound), generation lag (> 0).
  - ``throughput``   — a floor on a counter's windowed rate (rows mined per
    second); a window below the floor is an error sample.

* Each spec evaluates to a windowed **error ratio** e_W = errors/total over
  any lookback window W, differenced from a ring of timestamped
  :meth:`MetricsRegistry.raw_snapshot` cuts.  The **burn rate** is
  e_W / budget where budget = 1 - target_ratio: burn 1.0 spends the error
  budget exactly at the sustainable pace, burn 14.4 exhausts a 30-day
  budget in ~2 days — the SRE-workbook calibration that motivates the
  default rule ladder.

* :class:`BurnRule` is one multi-window alert condition: it fires when the
  burn rate over BOTH a long and a short window exceeds the threshold.  The
  short window makes alerts *recover* quickly (stop firing as soon as the
  recent past is clean) while the long window keeps them from triggering on
  a single bad tick.  Default ladder: fast-burn → ``page``, slow-burn →
  ``warn``.

* :class:`SLOEvaluator` drives an ok → warn → page **alert state machine**
  per spec: upgrades are immediate, downgrades require the calmer verdict
  to hold for ``clear_after_s`` (hysteresis — no flapping across a
  threshold), and a typed :class:`AlertEvent` is emitted only on state
  *transitions* (dedup — a burning SLO alerts once, not once per tick).
  Events go to subscribers (the router's closed-loop reactions live there)
  and, when configured, to a JSONL alert stream next to the metrics
  series.

Determinism for tests: the evaluator takes ``now_fn`` and exposes
:meth:`SLOEvaluator.tick` so a test can feed synthetic cuts on a synthetic
clock; the background thread is just ``tick`` on an interval.
"""

from __future__ import annotations

import dataclasses
import json
import math
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.obs.registry import Histogram, MetricsRegistry

OK = "ok"
WARN = "warn"
PAGE = "page"
_SEVERITY_RANK = {OK: 0, WARN: 1, PAGE: 2}


@dataclasses.dataclass(frozen=True)
class BurnRule:
    """One multi-window burn-rate condition: fires when the burn rate over
    BOTH windows is >= ``burn_threshold`` (long window = sustained damage,
    short window = still happening *now*, so recovery clears fast)."""

    severity: str               # WARN or PAGE
    long_window_s: float
    short_window_s: float
    burn_threshold: float

    def __post_init__(self):
        if self.severity not in (WARN, PAGE):
            raise ValueError(f"rule severity must be warn|page, got {self.severity!r}")
        if self.short_window_s > self.long_window_s:
            raise ValueError("short window must not exceed the long window")


# SRE-workbook-shaped default ladder, scaled to interactive-process
# lifetimes (seconds, not days): fast burn pages, slow burn warns.
DEFAULT_RULES: Tuple[BurnRule, ...] = (
    BurnRule(PAGE, long_window_s=60.0, short_window_s=5.0, burn_threshold=14.4),
    BurnRule(WARN, long_window_s=300.0, short_window_s=30.0, burn_threshold=3.0),
)


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """One declarative objective over metrics in a single registry."""

    name: str                       # unique id, e.g. "latency_p99"
    kind: str                       # latency | error_ratio | gauge_bound | throughput
    signal: str = ""                # semantic tag consumers key reactions on:
                                    # "latency" / "availability" / "freshness"
                                    # / "generation_lag" / "throughput"
    target_ratio: float = 0.99      # good-events fraction the objective demands
    # latency / gauge_bound / throughput: the metric's registry key
    metric: str = ""
    threshold_s: float = 0.0        # latency objective (seconds)
    # error_ratio: counter keys summed into errors / successes
    bad: Tuple[str, ...] = ()
    good: Tuple[str, ...] = ()
    # gauge_bound: the bound, and which side of it is an error
    bound: float = 0.0
    above_is_error: bool = True     # freshness: age > bound errs; set False
                                    # for floors (healthy_ratio < bound errs)
    # throughput: minimum sustained rate (units of the counter per second)
    floor_per_s: float = 0.0
    rules: Tuple[BurnRule, ...] = DEFAULT_RULES

    def __post_init__(self):
        if self.kind not in ("latency", "error_ratio", "gauge_bound", "throughput"):
            raise ValueError(f"unknown SLO kind {self.kind!r}")
        if not 0.0 < self.target_ratio < 1.0:
            raise ValueError("target_ratio must be in (0, 1): the error budget "
                             "is 1 - target_ratio and must be positive")
        if not self.rules:
            raise ValueError("an SLO needs at least one burn rule")

    @property
    def budget(self) -> float:
        return 1.0 - self.target_ratio

    @property
    def objective(self) -> float:
        """The human-facing objective number for status displays."""
        if self.kind == "latency":
            return self.threshold_s
        if self.kind == "gauge_bound":
            return self.bound
        if self.kind == "throughput":
            return self.floor_per_s
        return self.target_ratio


@dataclasses.dataclass(frozen=True)
class AlertEvent:
    """One alert state TRANSITION (never a repeat of an unchanged state)."""

    slo: str                    # spec name
    signal: str                 # spec semantic tag (reaction key)
    kind: str
    severity: str               # new state: ok | warn | page
    previous: str               # prior state
    burn_rate: float            # worst firing rule's long-window burn (0 on clear)
    window_s: float             # that rule's long window (0 on clear)
    value: float                # current error ratio / gauge value / rate
    objective: float
    t_wall: float               # epoch seconds (JSONL ordering across files)
    message: str

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @property
    def cleared(self) -> bool:
        return self.severity == OK


class _Cut:
    __slots__ = ("t", "metrics")

    def __init__(self, t: float, metrics: dict):
        self.t = t
        self.metrics = metrics


def _counter_sum(cut: _Cut, keys: Tuple[str, ...]) -> float:
    total = 0.0
    for k in keys:
        v = cut.metrics.get(k, 0.0)
        if isinstance(v, dict):
            v = v.get("count", 0.0)
        total += float(v)
    return total


def _hist(cut: _Cut, key: str) -> Optional[dict]:
    v = cut.metrics.get(key)
    return v if isinstance(v, dict) and v.get("kind") == "histogram" else None


class _SpecState:
    """Mutable evaluation state for one spec: the alert state machine plus
    the latest measured values (for status views)."""

    __slots__ = ("spec", "state", "since", "pending", "pending_since",
                 "burns", "value", "fired_rule")

    def __init__(self, spec: SLOSpec, t: float):
        self.spec = spec
        self.state = OK
        self.since = t
        self.pending: Optional[str] = None     # desired downgrade awaiting hysteresis
        self.pending_since = 0.0
        self.burns: Dict[float, Optional[float]] = {}   # window_s -> burn rate
        self.value = 0.0
        self.fired_rule: Optional[BurnRule] = None


class SLOEvaluator:
    """Background evaluator: registry cuts → burn rates → alert machine.

    ``subscribe(fn)`` registers a callback receiving every
    :class:`AlertEvent`; subscriber exceptions are counted, never fatal
    (an alert reaction must not kill the alerting loop).  ``jsonl_path``
    additionally appends every event to a JSONL alert stream.  ``tick()``
    is the whole evaluation step — call it directly (tests, CLIs) or let
    ``start()`` run it on ``interval_s``.
    """

    def __init__(
        self,
        registry: MetricsRegistry,
        specs: List[SLOSpec],
        *,
        interval_s: float = 0.25,
        clear_after_s: float = 1.0,
        jsonl_path: Optional[str] = None,
        now_fn: Callable[[], float] = time.perf_counter,
    ):
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO spec names: {names}")
        self.registry = registry
        self.specs = list(specs)
        self.interval_s = float(interval_s)
        self.clear_after_s = float(clear_after_s)
        self.jsonl_path = jsonl_path
        self._now = now_fn
        self._lock = threading.Lock()
        self._cuts: List[_Cut] = []
        self._subscribers: List[Callable[[AlertEvent], None]] = []
        self.subscriber_errors = 0
        self._history: List[AlertEvent] = []
        self._fh = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        t0 = self._now()
        self._states = {s.name: _SpecState(s, t0) for s in self.specs}
        self._max_window = max(
            (r.long_window_s for s in self.specs for r in s.rules), default=60.0
        )

    # ------------------------------------------------------------ wiring --
    def subscribe(self, fn: Callable[[AlertEvent], None]) -> None:
        with self._lock:
            self._subscribers.append(fn)

    def alert_history(self) -> List[AlertEvent]:
        with self._lock:
            return list(self._history)

    def states(self) -> Dict[str, str]:
        with self._lock:
            return {name: st.state for name, st in self._states.items()}

    def status(self) -> Dict[str, dict]:
        """Per-spec status for display: state, per-window burns, value."""
        with self._lock:
            out = {}
            for name, st in self._states.items():
                out[name] = {
                    "state": st.state,
                    "signal": st.spec.signal,
                    "kind": st.spec.kind,
                    "objective": st.spec.objective,
                    "value": st.value,
                    "burns": {f"{w:g}s": b for w, b in st.burns.items()},
                    "since": st.since,
                }
            return out

    # -------------------------------------------------------- measurement --
    def _window_cut(self, t: float, window_s: float) -> Optional[_Cut]:
        """Oldest cut not older than ``t - window_s`` (partial windows use
        the oldest available cut — a young process evaluates what it has)."""
        lo = t - window_s
        for cut in self._cuts:
            if cut.t >= lo:
                return cut
        return None

    def _error_ratio(self, spec: SLOSpec, old: _Cut, new: _Cut) -> Optional[float]:
        """Windowed error fraction between two cuts; None = no data."""
        if spec.kind == "error_ratio":
            bad = _counter_sum(new, spec.bad) - _counter_sum(old, spec.bad)
            good = _counter_sum(new, spec.good) - _counter_sum(old, spec.good)
            total = bad + good
            return None if total <= 0 else max(0.0, bad) / total
        if spec.kind == "latency":
            h_new, h_old = _hist(new, spec.metric), _hist(old, spec.metric)
            if h_new is None:
                return None
            counts_new = h_new["counts"]
            counts_old = h_old["counts"] if h_old is not None else [0] * len(counts_new)
            total = errors = 0
            for b, c_new in enumerate(counts_new):
                d = c_new - counts_old[b]
                if d <= 0:
                    continue
                total += d
                # bucket-upper-edge > threshold counts as over-objective: the
                # straddling bucket errs conservatively (never under-fires)
                if Histogram._edge(b) > spec.threshold_s:
                    errors += d
            return None if total == 0 else errors / total
        if spec.kind == "gauge_bound":
            # fraction of cut SAMPLES in the window violating the bound
            samples = [c for c in self._cuts if c.t >= old.t]
            vals = [c.metrics.get(spec.metric) for c in samples]
            vals = [float(v) for v in vals if isinstance(v, (int, float))]
            if not vals:
                return None
            if spec.above_is_error:
                bad = sum(1 for v in vals if v > spec.bound)
            else:
                bad = sum(1 for v in vals if v < spec.bound)
            return bad / len(vals)
        if spec.kind == "throughput":
            span = new.t - old.t
            if span <= 0:
                return None
            v_new, v_old = new.metrics.get(spec.metric), old.metrics.get(spec.metric)
            if not isinstance(v_new, (int, float)) or not isinstance(v_old, (int, float)):
                return None
            rate = max(0.0, float(v_new) - float(v_old)) / span
            return 1.0 if rate < spec.floor_per_s else 0.0
        return None

    def _current_value(self, spec: SLOSpec, new: _Cut, err_long: Optional[float]) -> float:
        if spec.kind == "gauge_bound":
            v = new.metrics.get(spec.metric)
            return float(v) if isinstance(v, (int, float)) else math.nan
        if spec.kind == "throughput":
            old = self._window_cut(new.t, spec.rules[0].long_window_s)
            if old is not None and new.t > old.t:
                v_new = new.metrics.get(spec.metric, 0.0)
                v_old = old.metrics.get(spec.metric, 0.0)
                if isinstance(v_new, (int, float)) and isinstance(v_old, (int, float)):
                    return max(0.0, float(v_new) - float(v_old)) / (new.t - old.t)
            return math.nan
        return err_long if err_long is not None else 0.0

    # --------------------------------------------------------- evaluation --
    def tick(self, cut: Optional[dict] = None) -> List[AlertEvent]:
        """One evaluation step: snapshot (or adopt ``cut``), window the ring,
        run every spec's rules, advance state machines, emit transitions."""
        t = self._now()
        metrics = self.registry.raw_snapshot() if cut is None else cut
        events: List[AlertEvent] = []
        with self._lock:
            self._cuts.append(_Cut(t, metrics))
            # retain 2x the longest window of history (burn math never needs more)
            lo = t - 2.0 * self._max_window
            while len(self._cuts) > 2 and self._cuts[0].t < lo:
                self._cuts.pop(0)
            new = self._cuts[-1]
            for st in self._states.values():
                events.extend(self._eval_spec(st, new, t))
            if events:
                self._history.extend(events)
        for ev in events:
            self._emit(ev)
        return events

    def _eval_spec(self, st: _SpecState, new: _Cut, t: float) -> List[AlertEvent]:
        spec = st.spec
        desired = OK
        fired: Optional[BurnRule] = None
        fired_burn = 0.0
        burns: Dict[float, Optional[float]] = {}
        err_long_any: Optional[float] = None
        for rule in spec.rules:
            e_long = e_short = None
            old_l = self._window_cut(t, rule.long_window_s)
            if old_l is not None and new.t > old_l.t:
                e_long = self._error_ratio(spec, old_l, new)
            old_s = self._window_cut(t, rule.short_window_s)
            if old_s is not None and new.t > old_s.t:
                e_short = self._error_ratio(spec, old_s, new)
            b_long = None if e_long is None else e_long / spec.budget
            b_short = None if e_short is None else e_short / spec.budget
            burns[rule.long_window_s] = b_long
            if e_long is not None:
                err_long_any = e_long
            if (
                b_long is not None and b_short is not None
                and b_long >= rule.burn_threshold and b_short >= rule.burn_threshold
                and _SEVERITY_RANK[rule.severity] > _SEVERITY_RANK[desired]
            ):
                desired = rule.severity
                fired = rule
                fired_burn = b_long
        st.burns = burns
        st.value = self._current_value(spec, new, err_long_any)
        return self._advance(st, desired, fired, fired_burn, t)

    def _advance(self, st: _SpecState, desired: str, rule: Optional[BurnRule],
                 burn: float, t: float) -> List[AlertEvent]:
        """State machine step.  Upgrades fire immediately; a downgrade must
        hold for ``clear_after_s`` before it lands (hysteresis: one calm tick
        in a burning stretch never clears — and so never re-fires — an
        alert)."""
        cur = st.state
        if _SEVERITY_RANK[desired] > _SEVERITY_RANK[cur]:
            st.pending = None
            return [self._transition(st, desired, rule, burn, t)]
        if _SEVERITY_RANK[desired] < _SEVERITY_RANK[cur]:
            if st.pending != desired:
                st.pending = desired
                st.pending_since = t
                return []
            if t - st.pending_since >= self.clear_after_s:
                st.pending = None
                return [self._transition(st, desired, rule, burn, t)]
            return []
        st.pending = None       # desired == current: nothing pending, no event
        return []

    def _transition(self, st: _SpecState, new_state: str,
                    rule: Optional[BurnRule], burn: float, t: float) -> AlertEvent:
        spec = st.spec
        prev = st.state
        st.state = new_state
        st.since = t
        st.fired_rule = rule
        if new_state == OK:
            msg = f"SLO {spec.name}: recovered ({prev} -> ok)"
        else:
            msg = (f"SLO {spec.name}: {new_state} — burn {burn:.1f}x budget over "
                   f"{rule.long_window_s:g}s (objective {spec.objective:g}, "
                   f"value {st.value:.4g})")
        return AlertEvent(
            slo=spec.name, signal=spec.signal, kind=spec.kind,
            severity=new_state, previous=prev,
            burn_rate=burn if rule is not None else 0.0,
            window_s=rule.long_window_s if rule is not None else 0.0,
            value=st.value, objective=spec.objective,
            t_wall=time.time(), message=msg,
        )

    # ------------------------------------------------------------ fan-out --
    def _emit(self, ev: AlertEvent) -> None:
        with self._lock:
            subs = list(self._subscribers)
            fh = self._fh
        for fn in subs:
            try:
                fn(ev)
            except Exception:
                with self._lock:
                    self.subscriber_errors += 1
        if fh is not None:
            line = json.dumps(ev.to_json())
            with self._lock:
                fh.write(line + "\n")
                fh.flush()

    # ---------------------------------------------------------- lifecycle --
    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.tick()

    def start(self) -> "SLOEvaluator":
        if self.jsonl_path:
            self._fh = open(self.jsonl_path, "a")
        self.tick()     # baseline cut so the first interval has a delta
        self._thread = threading.Thread(target=self._run, name="slo-evaluator",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self.tick()     # final evaluation so short runs still resolve states
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "SLOEvaluator":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


# --------------------------------------------------------------------------
# Canonical serving-spec builders (the serve CLI and examples share these).
# --------------------------------------------------------------------------

def serving_slos(
    prefix: str,
    *,
    p99_ms: float = 50.0,
    latency_target_ratio: float = 0.99,
    availability_target: float = 0.999,
    freshness_bound_s: Optional[float] = None,
    replicated: bool = False,
    rules: Tuple[BurnRule, ...] = DEFAULT_RULES,
) -> List[SLOSpec]:
    """The standard SLO set over a gateway ("gateway") or router ("router")
    metrics registry.  ``freshness_bound_s`` adds the rulebook-freshness
    objective only when the deployment actually refreshes continuously —
    a batch-mined rulebook ages unboundedly by design."""
    specs = [
        SLOSpec(
            name="latency_p99", kind="latency", signal="latency",
            metric=f"{prefix}_latency_seconds",
            threshold_s=p99_ms / 1e3, target_ratio=latency_target_ratio,
            rules=rules,
        ),
    ]
    if replicated:
        specs += [
            SLOSpec(
                name="availability", kind="error_ratio", signal="availability",
                bad=("router_failed", "router_shed"),
                good=("router_completed",),
                target_ratio=availability_target, rules=rules,
            ),
            SLOSpec(
                name="replica_availability", kind="gauge_bound",
                signal="availability",
                metric="router_healthy_replica_ratio",
                bound=1.0, above_is_error=False,       # any unhealthy replica errs
                target_ratio=availability_target, rules=rules,
            ),
            # counter-based disruption: failovers / attempt timeouts are
            # requests that needed RESCUE — recovered, but budget-burning.
            # Unlike the sampled health gauge (which can miss a replica that
            # dies and is revived between two cuts), counter deltas LATCH the
            # event, so a mid-load kill reliably fires this one even when
            # supervised recovery lands in milliseconds.
            SLOSpec(
                name="replica_disruption", kind="error_ratio",
                signal="availability",
                bad=("router_failovers", "router_attempt_timeouts"),
                good=("router_completed",),
                target_ratio=availability_target, rules=rules,
            ),
            SLOSpec(
                name="generation_lag", kind="gauge_bound", signal="generation_lag",
                metric="router_current_generation_lag",
                bound=0.0, above_is_error=True,        # any lagging replica errs
                target_ratio=0.99, rules=rules,
            ),
        ]
    else:
        specs.append(
            SLOSpec(
                name="availability", kind="error_ratio", signal="availability",
                bad=("gateway_rejected", "gateway_failed"),
                good=("gateway_completed",),
                target_ratio=availability_target, rules=rules,
            )
        )
    if freshness_bound_s is not None:
        specs.append(
            SLOSpec(
                name="freshness", kind="gauge_bound", signal="freshness",
                metric=f"{prefix}_generation_age_seconds",
                bound=float(freshness_bound_s), above_is_error=True,
                target_ratio=0.99, rules=rules,
            )
        )
    return specs


def mining_slos(
    *,
    rows_per_s_floor: float,
    rules: Tuple[BurnRule, ...] = DEFAULT_RULES,
) -> List[SLOSpec]:
    """Mining-throughput floor over a ``MiningObs`` registry."""
    return [
        SLOSpec(
            name="mining_throughput", kind="throughput", signal="throughput",
            metric="mine_rows_streamed", floor_per_s=float(rows_per_s_floor),
            target_ratio=0.99, rules=rules,
        )
    ]
