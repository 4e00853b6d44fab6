"""Shared observability substrate: metrics registry, span tracer, mining
job counters (DESIGN.md §13) — plus the active layer on top (§14): SLO
specs with burn-rate alerting and the bench-trajectory regression gate."""

from .registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    Sampler,
)
from .trace import Span, Tracer
from .mining import MiningObs, MiningProgress, PHASES
from .slo import (
    AlertEvent,
    BurnRule,
    DEFAULT_RULES,
    SLOEvaluator,
    SLOSpec,
    mining_slos,
    serving_slos,
)

__all__ = [
    "AlertEvent",
    "BurnRule",
    "Counter",
    "DEFAULT_RULES",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "MiningObs",
    "MiningProgress",
    "PHASES",
    "Sampler",
    "SLOEvaluator",
    "SLOSpec",
    "Span",
    "Tracer",
    "mining_slos",
    "serving_slos",
]
