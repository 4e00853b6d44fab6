"""Serving-side observability: latency histograms + gateway counters (§10).

Backed by the shared :mod:`repro_torch.obs` substrate since §13: every counter
and the latency histogram live in one :class:`~repro_torch.obs.MetricsRegistry`
whose re-entrant lock makes ``snapshot()`` **atomic across the whole metric
set** — a concurrent writer can never produce a torn snapshot where
``batch_rows_real`` comes from before a dispatch and ``batch_rows_padded``
from after it, and the derived ``batch_occupancy`` / ``cache_hit_rate`` are
computed from the same consistent cut.  The snapshot JSON shape is
unchanged; counters still read as plain attributes (``metrics.submitted``).

:class:`LatencyHistogram` is the registry histogram (log-bucketed,
conservative bucket-upper-edge quantiles — see ``obs/registry.py``), which
also gives it **merge**: the router aggregates replica latency histograms
by bucket-wise addition instead of re-measuring.
"""

from __future__ import annotations

import time
from typing import Optional

from repro_torch.obs.registry import (
    FLOOR_S as _FLOOR_S,       # re-exported for back-compat
    GROWTH as _GROWTH,
    NUM_BUCKETS as _NUM_BUCKETS,
    Gauge,
    Histogram,
    MetricsRegistry,
)


class LatencyHistogram(Histogram):
    """Log-bucketed latency histogram with exact count/sum/min/max."""

    def __init__(self, name: str = "latency_seconds", labels=None, lock=None):
        super().__init__(name, labels, lock=lock)


class GenerationAgeGauge(Gauge):
    """Live rulebook-freshness gauge (ROADMAP): seconds since the serving
    generation was committed.  ``mark()`` stamps the commit instant; reads
    compute the age at read time, so every snapshot/exposition sees the
    CURRENT age without anyone having to poll-update a stored value — the
    freshness SLO's signal can never go stale itself."""

    def __init__(self, name: str = "generation_age_seconds", labels=None, lock=None):
        super().__init__(name, labels, lock=lock)
        self._commit_t = time.perf_counter()

    def mark(self) -> None:
        with self._lock:
            self._commit_t = time.perf_counter()

    @property
    def value(self) -> float:
        with self._lock:
            return time.perf_counter() - self._commit_t


class _RegistryMetrics:
    """Base for counter bundles: registry-backed counters readable as plain
    attributes, with one lock covering every metric for atomic snapshots."""

    _COUNTER_FIELDS: tuple = ()

    def __init__(self, registry: Optional[MetricsRegistry] = None, *, prefix: str):
        self.registry = registry if registry is not None else MetricsRegistry()
        self._lock = self.registry.lock
        self._counters = {f: self.registry.counter(f"{prefix}_{f}")
                          for f in self._COUNTER_FIELDS}
        self.latency = self.registry.register(
            LatencyHistogram(f"{prefix}_latency_seconds", lock=self.registry.lock))

    def __getattr__(self, name):
        counters = self.__dict__.get("_counters")
        if counters is not None and name in counters:
            return counters[name].value
        raise AttributeError(f"{type(self).__name__!s} has no attribute {name!r}")

    def _inc(self, field: str, n: int = 1) -> None:
        self._counters[field].inc(n)


class GatewayMetrics(_RegistryMetrics):
    """All gateway counters + the request-latency histogram, one lock."""

    _COUNTER_FIELDS = (
        "submitted",          # admitted into the queue (or served from cache)
        "rejected",           # refused at admission (queue full / closed)
        "completed",          # responses delivered (cache hits included)
        "failed",             # futures resolved with an exception
        "cache_hits",
        "cache_misses",
        "swaps",
        "deadline_expired",   # requests dropped past-deadline at dispatch
        "worker_restarts",    # dead dispatch workers re-armed (§11)
        "batches",            # dispatches through the match step
        "batch_rows_real",    # requests actually in dispatched batches
        "batch_rows_padded",  # rows of the padded buckets
    )

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        super().__init__(registry, prefix="gateway")
        self.generation_age = self.registry.register(
            GenerationAgeGauge("gateway_generation_age_seconds",
                               lock=self.registry.lock))

    def mark_generation_commit(self) -> None:
        """Stamp the freshness clock — called when a generation commits
        (initial placement and every hot-swap commit)."""
        self.generation_age.mark()

    def record_admission(self, accepted: bool) -> None:
        self._inc("submitted" if accepted else "rejected")

    def record_cache(self, hit: bool) -> None:
        self._inc("cache_hits" if hit else "cache_misses")

    def record_batch(self, real_rows: int, padded_rows: int) -> None:
        with self._lock:
            self._inc("batches")
            self._inc("batch_rows_real", real_rows)
            self._inc("batch_rows_padded", padded_rows)

    def record_response(self, latency_s: float, failed: bool = False) -> None:
        if failed:
            self._inc("failed")
        else:
            self._inc("completed")
            self.latency.record(latency_s)

    def record_swap(self) -> None:
        with self._lock:
            self._inc("swaps")
            self.generation_age.mark()

    def record_deadline_expired(self) -> None:
        self._inc("deadline_expired")

    def record_worker_restart(self) -> None:
        self._inc("worker_restarts")

    @property
    def batch_occupancy(self) -> float:
        """Real rows / padded bucket rows over all dispatches (1.0 = full).
        Both counters are read in one lock hold — never torn mid-dispatch."""
        with self._lock:
            real = self._counters["batch_rows_real"].value
            padded = self._counters["batch_rows_padded"].value
        return real / padded if padded else 0.0

    @property
    def cache_hit_rate(self) -> float:
        with self._lock:
            hits = self._counters["cache_hits"].value
            misses = self._counters["cache_misses"].value
        total = hits + misses
        return hits / total if total else 0.0

    def snapshot(self) -> dict:
        # One lock hold covers counters, derived ratios AND the latency
        # histogram (they share the registry lock): a fully atomic cut.
        with self._lock:
            out = {f: self._counters[f].value for f in self._COUNTER_FIELDS}
            out["generation_age_s"] = self.generation_age.value
            out["batch_occupancy"] = (
                out["batch_rows_real"] / out["batch_rows_padded"]
                if out["batch_rows_padded"] else 0.0)
            total = out["cache_hits"] + out["cache_misses"]
            out["cache_hit_rate"] = out["cache_hits"] / total if total else 0.0
            out["latency"] = self.latency.snapshot()
        return out


class RouterMetrics(_RegistryMetrics):
    """Replica-router counters + the router-level latency histogram (§12).

    Router latency is submit → terminal outcome INCLUDING failover retries
    and backoff, so it is an end-to-end client view; a replica gateway's own
    histogram sees only the attempts that reached it."""

    _COUNTER_FIELDS = (
        "routed",             # requests accepted by the router
        "completed",          # outer futures resolved with a Response
        "failed",             # outer futures resolved with an exception
        "shed",               # refused: every candidate replica dead/saturated
        "failovers",          # re-submissions to another replica
        "attempt_timeouts",   # attempts abandoned as unresponsive
        "deadline_failed",    # outer futures failed with DeadlineExceeded
        "retries_exhausted",  # outer futures failed after the retry budget
        "resyncs",            # lagging replicas re-synced to the target gen
        "swap_prepare_failures",  # replicas that failed two-phase prepare
        "coordinated_swaps",      # successful two-phase hot-swaps
        "replica_deaths",         # replicas declared dead (restart storm)
        "brownout_sheds",         # requests shed by alert-driven brownout (§14)
        "alert_resyncs",          # re-syncs triggered by a generation-lag alert
    )

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        super().__init__(registry, prefix="router")
        self._max_lag = self.registry.gauge("router_max_generation_lag")
        self._cur_lag = self.registry.gauge("router_current_generation_lag")
        # fraction of replicas currently HEALTHY — the replica-availability
        # SLO's signal; 1.0 until the health monitor first reports
        self._healthy_ratio = self.registry.gauge("router_healthy_replica_ratio")
        self._healthy_ratio.set(1.0)
        self.generation_age = self.registry.register(
            GenerationAgeGauge("router_generation_age_seconds",
                               lock=self.registry.lock))

    def mark_generation_commit(self) -> None:
        """Stamp the freshness clock at coordinated-swap commit time."""
        self.generation_age.mark()

    def record_routed(self) -> None:
        self._inc("routed")

    def record_completed(self, latency_s: float) -> None:
        self._inc("completed")
        self.latency.record(latency_s)

    def record_failed(self, *, deadline: bool = False, exhausted: bool = False) -> None:
        with self._lock:
            self._inc("failed")
            if deadline:
                self._inc("deadline_failed")
            if exhausted:
                self._inc("retries_exhausted")

    def record_shed(self) -> None:
        self._inc("shed")

    def record_failover(self) -> None:
        self._inc("failovers")

    def record_attempt_timeout(self) -> None:
        self._inc("attempt_timeouts")

    def record_resync(self) -> None:
        self._inc("resyncs")

    def record_swap_prepare_failure(self) -> None:
        self._inc("swap_prepare_failures")

    def record_coordinated_swap(self) -> None:
        self._inc("coordinated_swaps")

    def record_replica_death(self) -> None:
        self._inc("replica_deaths")

    def record_brownout_shed(self) -> None:
        with self._lock:
            self._inc("brownout_sheds")
            self._inc("shed")

    def record_alert_resync(self) -> None:
        self._inc("alert_resyncs")

    def set_healthy_ratio(self, ratio: float) -> None:
        self._healthy_ratio.set(ratio)

    @property
    def healthy_replica_ratio(self) -> float:
        return float(self._healthy_ratio.value)

    def observe_generation_lag(self, lag: int) -> None:
        with self._lock:
            self._cur_lag.set(lag)
            self._max_lag.max(lag)

    @property
    def max_generation_lag(self) -> int:
        return int(self._max_lag.value)

    @property
    def current_generation_lag(self) -> int:
        return int(self._cur_lag.value)

    def snapshot(self) -> dict:
        with self._lock:
            out = {f: self._counters[f].value for f in self._COUNTER_FIELDS}
            out["max_generation_lag"] = int(self._max_lag.value)
            out["current_generation_lag"] = int(self._cur_lag.value)
            out["healthy_replica_ratio"] = float(self._healthy_ratio.value)
            out["generation_age_s"] = self.generation_age.value
            out["latency"] = self.latency.snapshot()
        return out
