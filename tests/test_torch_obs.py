"""PyTorch port: the observability copies (``repro_torch.obs``) on the CPU.

Mirrors ``tests/test_obs_registry.py``, ``tests/test_obs_trace.py``,
``tests/test_obs_mining.py``, ``tests/test_slo.py`` and
``tests/test_regress.py`` against the port's modules (the mining counters
on the port's streamed miners, the router on the port's gateways), then
holds each copy to the JAX package's module: the same sequence of
operations gives the same registry snapshot JSON, the same Chrome trace
events, the same alert transitions on an injected clock and the same
regress verdicts.
"""

import copy
import functools
import io
import json
import os
import pathlib
import threading
import time

import pytest

torch = pytest.importorskip("torch")
import numpy as np  # noqa: E402
from torch_obs_parity import port_only_counters  # noqa: E402

from repro_torch.core import streaming as _stm  # noqa: E402
from repro_torch.core.apriori import AprioriConfig  # noqa: E402
from repro_torch.data.store import ingest_dense  # noqa: E402
from repro_torch.distributed.fault_tolerance import (FaultConfig, InjectedFailure,  # noqa: E402
                                                     run_partitions)
from repro_torch.obs import (AlertEvent, BurnRule, MetricsRegistry, MiningObs,  # noqa: E402
                             MiningProgress, SLOEvaluator, SLOSpec, Tracer,
                             mining_slos, serving_slos)
from repro_torch.obs.registry import Counter, Gauge, Histogram, Sampler  # noqa: E402
from repro_torch.obs.regress import (INVARIANTS, check_files, check_trajectory,  # noqa: E402
                                     main, parse_derived)

mine_streamed = functools.partial(_stm.mine_streamed, device="cpu")
mine_son_streamed = functools.partial(_stm.mine_son_streamed, device="cpu")


# ======================== registry ======================================
# ---------------------------------------------------------------- histogram --

def test_histogram_merge_equals_recording_the_union():
    """Property: merging per-replica histograms is indistinguishable from one
    histogram that recorded every sample — same count/sum/min/max and same
    quantiles (bucket resolution is identical, so equality is EXACT)."""
    rng = np.random.default_rng(42)
    for trial in range(5):
        parts = [Histogram() for _ in range(4)]
        union = Histogram()
        for h in parts:
            for v in rng.lognormal(mean=-6.0, sigma=2.0, size=rng.integers(1, 200)):
                h.record(float(v))
                union.record(float(v))
        merged = Histogram.merged(parts)
        assert merged.count == union.count
        assert merged.sum == pytest.approx(union.sum)
        assert merged.min == union.min
        assert merged.max == union.max
        for q in (0.0, 0.5, 0.9, 0.95, 0.99, 1.0):
            assert merged.quantile(q) == union.quantile(q), (trial, q)
        assert merged.snapshot() == pytest.approx(union.snapshot())


def test_histogram_quantile_conservative():
    """Quantiles come from bucket upper edges: never below the true value,
    and clamped to the observed max."""
    h = Histogram()
    samples = [0.001, 0.002, 0.004, 0.010, 0.100]
    for s in samples:
        h.record(s)
    assert h.quantile(1.0) == pytest.approx(0.100)
    assert h.quantile(0.5) >= 0.004 * (1 - 1e-9)
    assert h.quantile(0.0) >= 0.001 * (1 - 1e-9)


def test_histogram_merge_from_empty_and_into_empty():
    a, b = Histogram(), Histogram()
    a.record(0.01)
    b.merge_from(a)                      # into empty
    assert b.count == 1 and b.min == a.min and b.max == a.max
    b.merge_from(Histogram())            # from empty: no-op
    assert b.count == 1


# ----------------------------------------------------------------- registry --

def test_registry_get_or_create_and_labels():
    reg = MetricsRegistry()
    c1 = reg.counter("jobs", labels={"level": "1"})
    c2 = reg.counter("jobs", labels={"level": "1"})
    c3 = reg.counter("jobs", labels={"level": "2"})
    assert c1 is c2 and c1 is not c3
    c1.inc(3)
    snap = reg.snapshot()
    assert snap['jobs{level="1"}'] == 3
    assert snap['jobs{level="2"}'] == 0


def test_registry_snapshot_is_atomic_under_concurrent_writers():
    """Writers keep two counters in lockstep (+2 real / +4 padded per batch);
    every registry snapshot must observe them at an exact 0.5 ratio — a torn
    read would show a ratio off by one update."""
    reg = MetricsRegistry()
    real = reg.counter("rows_real")
    padded = reg.counter("rows_padded")
    stop = threading.Event()

    def writer():
        while not stop.is_set():
            with reg.lock:
                real.inc(2)
                padded.inc(4)

    threads = [threading.Thread(target=writer, daemon=True) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        for _ in range(300):
            snap = reg.snapshot()
            r, p = snap["rows_real"], snap["rows_padded"]
            assert r * 2 == p, f"torn snapshot: real={r} padded={p}"
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=5)


def test_prometheus_exposition_shape():
    reg = MetricsRegistry()
    reg.counter("requests", labels={"route": "mine"}).inc(7)
    reg.gauge("depth").set(3)
    reg.histogram("latency_seconds").record(0.004)
    text = reg.to_prometheus()
    assert '# TYPE requests counter' in text
    assert 'requests{route="mine"} 7' in text
    assert '# TYPE depth gauge' in text
    assert "depth 3" in text
    assert "# TYPE latency_seconds histogram" in text
    assert "latency_seconds_count 1" in text
    assert "latency_seconds_sum" in text
    # cumulative buckets end at +Inf with the total count
    assert 'latency_seconds_bucket{le="+Inf"} 1' in text


def test_gauge_max_and_counter_monotonic():
    reg = MetricsRegistry()
    g = reg.gauge("peak")
    g.max(4.0)
    g.max(2.0)
    assert g.value == 4.0
    with pytest.raises(ValueError):
        reg.counter("c").inc(-1)


# ------------------------------------------------------------------ sampler --

def test_sampler_jsonl_round_trip(tmp_path):
    reg = MetricsRegistry()
    c = reg.counter("events")
    path = tmp_path / "series.jsonl"
    with Sampler(reg, str(path), interval_s=0.01) as s:
        for i in range(5):
            c.inc()
    assert s.samples_written >= 1           # stop() always writes a final one
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert len(lines) == s.samples_written
    for rec in lines:
        assert set(rec) == {"t", "metrics"}
        assert rec["metrics"]["events"] <= 5
    # the series is monotone in t and in the counter
    ts = [rec["t"] for rec in lines]
    vals = [rec["metrics"]["events"] for rec in lines]
    assert ts == sorted(ts)
    assert vals == sorted(vals)
    assert vals[-1] == 5                    # final sample sees the last inc


# -------------------------------------------- prometheus exposition (§14) --

def test_prometheus_label_values_are_escaped():
    reg = MetricsRegistry()
    reg.counter("events", labels={"path": 'a\\b"c\nd'}).inc(1)
    text = reg.to_prometheus()
    # backslash, double-quote and newline escaped per the text format
    assert 'events{path="a\\\\b\\"c\\nd"} 1' in text
    assert text.count("\n# TYPE") + 1 == 1      # one family, one TYPE line


def test_prometheus_histogram_series_are_consistent():
    """``_bucket`` counts are cumulative, ``le`` edges are the histogram's
    real bucket edges in increasing order ending at +Inf with the total,
    and ``_count`` / ``_sum`` reconcile with the recorded samples."""
    import re

    reg = MetricsRegistry()
    h = reg.histogram("lat_seconds", labels={"tier": "serve"})
    samples = [0.001, 0.001, 0.004, 0.050, 1.5]
    for s in samples:
        h.record(s)
    text = reg.to_prometheus()
    bucket_lines = re.findall(
        r'lat_seconds_bucket\{le="([^"]+)",tier="serve"\} (\d+)', text)
    assert bucket_lines[-1][0] == "+Inf"
    assert int(bucket_lines[-1][1]) == len(samples)
    edges = [float(le) for le, _ in bucket_lines[:-1]]
    cums = [int(c) for _, c in bucket_lines]
    assert edges == sorted(edges)               # increasing le edges
    assert cums == sorted(cums)                 # cumulative counts
    # every edge must actually cover its cumulative count of samples
    for le, cum in zip(edges, cums):
        assert sum(1 for s in samples if s <= le) >= cum
    assert f"lat_seconds_count{{tier=\"serve\"}} {len(samples)}" in text
    m = re.search(r'lat_seconds_sum\{tier="serve"\} ([0-9.e+-]+)', text)
    assert float(m.group(1)) == pytest.approx(sum(samples), rel=1e-6)


def test_raw_snapshot_shape_and_differencing():
    """The SLO evaluator's input: full-resolution histogram counts that can
    be differenced between cuts, plus plain floats for counters/gauges."""
    reg = MetricsRegistry()
    c = reg.counter("done")
    reg.gauge("depth").set(2.0)
    h = reg.histogram("lat_seconds")
    h.record(0.004)
    cut0 = reg.raw_snapshot()
    assert cut0["done"] == 0.0 and cut0["depth"] == 2.0
    hs = cut0["lat_seconds"]
    assert hs["kind"] == "histogram" and hs["count"] == 1
    assert sum(hs["counts"]) == 1 and hs["sum"] == pytest.approx(0.004)
    c.inc(3)
    h.record(0.100)
    cut1 = reg.raw_snapshot()
    assert cut1["done"] - cut0["done"] == 3.0
    delta = [a - b for a, b in zip(cut1["lat_seconds"]["counts"], hs["counts"])]
    assert sum(delta) == 1                      # exactly the new sample
    assert cut0["lat_seconds"]["counts"] is not cut1["lat_seconds"]["counts"]

# ======================== trace =========================================
def test_span_nesting_and_ids():
    tr = Tracer(sample_rate=1.0)
    root = tr.root("request", top_k=5)
    assert root is not None and root.parent_id is None
    inner = root.child("dispatch", bucket=8)
    assert inner.trace_id == root.trace_id
    assert inner.parent_id == root.span_id
    assert inner.span_id != root.span_id
    inner.end(outcome="ok")
    root.end()
    spans = tr.spans()
    assert [s.name for s in spans] == ["dispatch", "request"]  # finish order
    assert spans[0].t0 >= root.t0 and spans[0].t1 <= spans[1].t1


def test_end_is_idempotent():
    tr = Tracer(sample_rate=1.0)
    sp = tr.root("op")
    sp.end(outcome="failed")
    t1 = sp.t1
    sp.end(outcome="ok")        # second close: ignored entirely
    assert sp.t1 == t1
    assert sp.attrs["outcome"] == "failed"
    assert len(tr.spans()) == 1


def test_deterministic_sampling():
    tr = Tracer(sample_rate=0.25)
    picks = [tr.root("r", i=i) is not None for i in range(12)]
    # every 4th root, starting with the first — no RNG involved
    assert picks == [i % 4 == 0 for i in range(12)]
    assert tr.sampled_roots == 3
    # rate 0 never samples; force bypasses sampling without consuming a slot
    tr0 = Tracer(sample_rate=0.0)
    assert tr0.root("r") is None
    assert tr0.root("swap", force=True) is not None


def test_unsampled_paths_are_none_safe():
    tr = Tracer(sample_rate=0.0)
    parent = tr.root("r")
    assert parent is None
    assert tr.child(parent, "c") is None
    tr.add_span(parent, "phase", 0.0, 1.0)       # silently dropped
    with tr.span(parent, "ctx") as sp:
        assert sp is None
    assert tr.spans() == []


def test_ring_buffer_capacity():
    tr = Tracer(sample_rate=1.0, capacity=8)
    for i in range(20):
        tr.root(f"op{i}").end()
    spans = tr.spans()
    assert len(spans) == 8
    assert spans[0].name == "op12" and spans[-1].name == "op19"


def test_add_span_records_elapsed_interval():
    tr = Tracer(sample_rate=1.0)
    root = tr.root("level")
    t0 = time.perf_counter()
    t1 = t0 + 0.25
    tr.add_span(root, "count_kernel", t0, t1, chunk=3)
    root.end()
    kernel = next(s for s in tr.spans() if s.name == "count_kernel")
    assert kernel.parent_id == root.span_id
    assert kernel.duration_s() == 0.25
    assert kernel.attrs["chunk"] == 3


def test_chrome_export_schema(tmp_path):
    tr = Tracer(sample_rate=1.0)
    root = tr.root("request")
    child = root.child("dispatch")
    child.end()
    root.end(outcome="ok")
    path = tmp_path / "trace.json"
    tr.save_chrome(str(path))

    doc = json.loads(path.read_text())            # must be valid JSON
    assert set(doc) == {"traceEvents", "displayTimeUnit"}
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    ms = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    assert len(xs) == 2 and len(ms) >= 1
    for e in xs:                                   # perfetto-required keys
        assert {"name", "ph", "ts", "dur", "pid", "tid", "args"} <= set(e)
        assert e["ts"] >= 0 and e["dur"] >= 0
        assert {"trace_id", "span_id"} <= set(e["args"])
    assert ms[0]["name"] == "thread_name"
    # the child event nests inside the root event on the µs timeline
    ce = next(e for e in xs if e["name"] == "dispatch")
    re = next(e for e in xs if e["name"] == "request")
    assert ce["args"]["parent_id"] == re["args"]["span_id"]
    assert re["ts"] <= ce["ts"]
    assert ce["ts"] + ce["dur"] <= re["ts"] + re["dur"] + 1e-3
    assert ce["args"]["trace_id"] == re["args"]["trace_id"]


def test_tracer_is_thread_safe_under_concurrent_roots():
    import threading

    tr = Tracer(sample_rate=1.0)

    def burst(n):
        for _ in range(n):
            sp = tr.root("op")
            sp.child("inner").end()
            sp.end()

    threads = [threading.Thread(target=burst, args=(50,)) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    spans = tr.spans()
    assert len(spans) == 4 * 50 * 2
    assert len({s.span_id for s in spans}) == len(spans)   # ids never collide
    doc = tr.export_chrome()
    # every event maps to a registered exporter tid (the OS may reuse thread
    # idents across short-lived threads, so only >= 1 distinct is guaranteed)
    tids = {e["tid"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert tids and all(t >= 1 for t in tids)

# ======================== mining ========================================
CFG = AprioriConfig(min_support=0.02, max_k=3)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    rng = np.random.default_rng(11)
    dense = (rng.random((3000, 48)) < 0.12).astype(np.uint8)
    path = os.path.join(str(tmp_path_factory.mktemp("obs_store")), "db")
    return ingest_dense(dense, path, shard_rows=800)


def _assert_same_result(a, b):
    assert set(a.levels) == set(b.levels)
    for k in a.levels:
        assert np.array_equal(a.levels[k][0], b.levels[k][0])
        assert np.array_equal(a.levels[k][1], b.levels[k][1])


def test_mine_streamed_obs_parity_and_counters(store):
    """Instrumentation is observation-only: the mined result is bit-identical
    with obs on/off, and the counters reconcile with the result."""
    plain = mine_streamed(store, CFG, chunk_rows=512)

    reg = MetricsRegistry()
    tracer = Tracer(sample_rate=1.0)
    obs = MiningObs(registry=reg, tracer=tracer)
    inst = mine_streamed(store, CFG, chunk_rows=512, obs=obs)

    _assert_same_result(plain, inst)

    snap = obs.counters()
    total_frequent = sum(v[0].shape[0] for v in plain.levels.values())
    # mine_levels counts levels ATTEMPTED — the final attempt may keep zero
    # itemsets and so not appear in the result dict
    assert len(plain.levels) <= snap["mine_levels"] <= len(plain.levels) + 1
    assert snap["mine_frequent_total"] == total_frequent
    for k, (sets, _) in plain.levels.items():
        assert snap[f'mine_frequent{{level="{k}"}}'] == sets.shape[0]
        assert snap[f'mine_candidates{{level="{k}"}}'] >= sets.shape[0]
    # every level streams the full store once per candidate pass
    assert snap["mine_rows_streamed"] >= store.num_transactions
    assert snap["mine_chunks_streamed"] > 0
    # all five phases of the wall-time split are populated
    for phase in ("candidate_gen", "prefetch_stall", "count_kernel", "host_sync"):
        assert snap[f'mine_phase_seconds{{phase="{phase}"}}'] > 0.0, phase
    # the trace shows one mine.level root per attempted level, phase children
    roots = [s for s in tracer.spans() if s.name == "mine.level"]
    assert len(roots) == snap["mine_levels"]
    kinds = {s.name for s in tracer.spans()}
    assert {"mine.candidate_gen", "mine.count_kernel", "mine.prefetch_stall"} <= kinds


def test_mine_son_streamed_obs_parity_and_fault_counters(store):
    fault = FaultConfig(max_workers=2)
    plain = mine_son_streamed(store, CFG, chunk_rows=512, fault=fault)

    obs = MiningObs(registry=MetricsRegistry())
    inst = mine_son_streamed(store, CFG, chunk_rows=512, fault=fault, obs=obs)

    _assert_same_result(plain, inst)
    snap = obs.counters()
    assert snap["mine_partitions_completed"] == store.num_partitions
    assert snap["mine_partition_attempts"] >= store.num_partitions
    assert snap["mine_chunks_streamed"] > 0


def test_fault_executor_counters_mirror_report():
    """Counters track the FaultReport exactly: retries, skips, completions."""
    def worker(p):
        return p * 10

    def injector(p, attempt):
        if p == 1 and attempt == 0:
            raise InjectedFailure("boom")
        if p == 2:                       # always fails -> exhausts -> skipped
            raise InjectedFailure("dead")

    obs = MiningObs(registry=MetricsRegistry())
    fault = FaultConfig(max_retries=1, backoff_s=0.0, speculative=False,
                        on_exhausted="skip", failure_injector=injector)
    results, report = run_partitions(worker, 4, fault, obs=obs)
    assert results == [0, 10, None, 30]

    snap = obs.counters()
    assert snap["mine_partitions_completed"] == report.completed == 3
    assert snap["mine_partition_retries"] == report.retries == 2
    assert snap["mine_partitions_skipped"] == len(report.skipped) == 1
    assert snap["mine_partition_attempts"] == sum(report.attempts.values())
    assert "speculative_wins" in report.to_json()


def test_speculative_win_counter():
    """A straggling partition whose backup copy finishes first shows up in
    both the report and the live counter."""
    import threading

    release = threading.Event()
    calls = {}
    lock = threading.Lock()

    def worker(p):
        with lock:
            calls[p] = calls.get(p, 0) + 1
            nth = calls[p]
        if p == 3 and nth == 1:
            release.wait(timeout=30)     # original copy stalls...
        return p

    obs = MiningObs(registry=MetricsRegistry())
    fault = FaultConfig(max_workers=2, speculative=True, speculative_factor=2.0,
                        backoff_s=0.0)
    try:
        results, report = run_partitions(worker, 4, fault, obs=obs)
    finally:
        release.set()
    assert results == [0, 1, 2, 3]
    snap = obs.counters()
    assert snap["mine_speculative_issued"] == report.speculative_issued
    assert snap["mine_speculative_wins"] == report.speculative_wins
    if report.speculative_issued:        # ...so the backup wins the race
        assert report.speculative_wins >= 1


def test_mining_progress_reporter(store):
    out = io.StringIO()
    progress = MiningProgress(total_rows=store.num_transactions, out=out,
                              interval_s=0.0)
    obs = MiningObs(registry=MetricsRegistry(), progress=progress)
    mine_streamed(store, CFG, chunk_rows=512, obs=obs)
    obs.finish()
    text = out.getvalue()
    assert progress.lines_emitted > 0
    assert "[mine]" in text and "L1" in text
    assert "rows/s" in text


def test_router_stats_aggregate_replica_histograms_by_merge(small_db):
    """The router's latency view is the MERGE of its replicas' histograms —
    total count equals the sum of per-replica counts, no re-measuring."""
    from repro_torch.core.apriori import mine
    from repro_torch.serving import Router, compile_rulebook

    rb = compile_rulebook(
        mine(small_db, AprioriConfig(min_support=0.05, max_k=3, representation="packed"),
             device="cpu"),
        min_confidence=0.3, num_items=32)
    with Router(rb, 2, device="cpu", max_wait_ms=0.2, cache_capacity=0) as router:
        baskets = [list(np.flatnonzero(r)) for r in small_db[:20]]
        for b in baskets:
            router.query(b, timeout=30)
        stats = router.stats()
        merged = stats["replica_latency"]
        per_replica = [r["gateway"]["latency"]["count"] for r in stats["replicas"]]
        assert merged["count"] == sum(per_replica) == len(baskets)
        assert merged["p99_ms"] >= merged["p50_ms"] >= 0.0

# ======================== slo ===========================================
class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


PAGE_RULE = BurnRule("page", long_window_s=10.0, short_window_s=2.0,
                     burn_threshold=10.0)


def make_eval(spec, **kw):
    clock = FakeClock()
    ev = SLOEvaluator(MetricsRegistry(), [spec], clear_after_s=1.0,
                      now_fn=clock, **kw)
    return ev, clock


def ratio_spec(**overrides):
    kw = dict(name="avail", kind="error_ratio", signal="availability",
              bad=("bad",), good=("good",), target_ratio=0.99,
              rules=(PAGE_RULE,))
    kw.update(overrides)
    return SLOSpec(**kw)


# ------------------------------------------------------------- burn math --

def test_error_ratio_burn_fires_page_and_reports_burn_rate():
    ev, clock = make_eval(ratio_spec())
    ev.tick(cut={"bad": 0.0, "good": 0.0})
    clock.advance(1.0)
    assert ev.tick(cut={"bad": 0.0, "good": 100.0}) == []
    clock.advance(1.0)
    events = ev.tick(cut={"bad": 50.0, "good": 150.0})
    # windowed ratio 50/200 = 0.25; budget 0.01 -> burn 25x >= 10 on BOTH
    # windows (the burst is inside the 2s short window too)
    assert [e.severity for e in events] == ["page"]
    assert events[0].previous == "ok"
    assert events[0].burn_rate == pytest.approx(25.0)
    assert events[0].window_s == 10.0
    assert ev.states() == {"avail": "page"}


def test_no_data_and_clean_windows_stay_ok():
    ev, clock = make_eval(ratio_spec())
    assert ev.tick(cut={}) == []                 # no counters at all
    clock.advance(1.0)
    assert ev.tick(cut={"bad": 0.0, "good": 500.0}) == []
    assert ev.states() == {"avail": "ok"}


def test_short_window_gates_stale_burns():
    """An old burst still inside the long window but outside the short one
    must NOT fire: the multi-window AND is what makes recovery fast."""
    ev, clock = make_eval(ratio_spec())
    ev.tick(cut={"bad": 0.0, "good": 0.0})
    # jump 5s, arriving with a burst already in the books: the long window
    # (10s) spans it (burn 20x), but the short window (2s) only ever sees
    # the clean recent deltas
    clock.advance(5.0)
    ev.tick(cut={"bad": 100.0, "good": 400.0})
    clock.advance(0.5)
    ev.tick(cut={"bad": 100.0, "good": 500.0})
    clock.advance(0.5)
    assert ev.tick(cut={"bad": 100.0, "good": 600.0}) == []
    assert ev.alert_history() == []
    assert ev.states() == {"avail": "ok"}


def test_latency_kind_counts_over_threshold_buckets():
    spec = SLOSpec(name="lat", kind="latency", signal="latency",
                   metric="latency_seconds", threshold_s=0.05,
                   target_ratio=0.9, rules=(BurnRule("page", 10.0, 2.0, 5.0),))
    reg = MetricsRegistry()
    h = reg.histogram("latency_seconds")
    clock = FakeClock()
    ev = SLOEvaluator(reg, [spec], clear_after_s=1.0, now_fn=clock)
    ev.tick()                                    # baseline: empty histogram
    for _ in range(95):
        h.record(0.001)
    for _ in range(5):
        h.record(0.2)
    clock.advance(1.0)
    assert ev.tick() == []                       # 5% errs = burn 0.5 < 5
    for _ in range(100):
        h.record(0.2)                            # all over the objective now
    clock.advance(1.0)
    events = ev.tick()
    assert [e.severity for e in events] == ["page"]
    assert events[0].kind == "latency"
    assert events[0].objective == pytest.approx(0.05)


def test_gauge_bound_both_directions():
    above = SLOSpec(name="age", kind="gauge_bound", signal="freshness",
                    metric="g", bound=5.0, above_is_error=True,
                    target_ratio=0.9, rules=(BurnRule("page", 10.0, 2.0, 5.0),))
    ev, clock = make_eval(above)
    for v in (1.0, 1.0, 10.0, 10.0):             # half the samples violate
        ev.tick(cut={"g": v})
        clock.advance(0.5)
    assert ev.states() == {"age": "page"}        # 0.5 / 0.1 budget = 5x

    below = SLOSpec(name="healthy", kind="gauge_bound", signal="availability",
                    metric="g", bound=1.0, above_is_error=False,
                    target_ratio=0.9, rules=(BurnRule("page", 10.0, 2.0, 5.0),))
    ev2, clock2 = make_eval(below)
    for v in (1.0, 1.0, 0.5, 0.5):               # dips BELOW the floor err
        ev2.tick(cut={"g": v})
        clock2.advance(0.5)
    assert ev2.states() == {"healthy": "page"}


def test_throughput_floor():
    spec = SLOSpec(name="tput", kind="throughput", signal="throughput",
                   metric="rows", floor_per_s=100.0, target_ratio=0.99,
                   rules=(BurnRule("page", 2.0, 1.0, 10.0),))
    ev, clock = make_eval(spec)
    ev.tick(cut={"rows": 0.0})
    clock.advance(1.0)
    assert ev.tick(cut={"rows": 1000.0}) == []   # 1000 rows/s >= floor
    clock.advance(2.0)
    assert ev.tick(cut={"rows": 1001.0}) == []   # stall begins (short window
    clock.advance(0.5)                           # has no delta yet)
    events = ev.tick(cut={"rows": 1001.0})       # ~0 rows/s < floor: fire
    assert [e.severity for e in events] == ["page"]


# ---------------------------------------------------- state machine -------

def burn_cut(n):
    """A cut n steps into a sustained 50% error burn."""
    return {"bad": 50.0 * n, "good": 50.0 * n}


def test_sustained_burn_emits_exactly_one_event():
    ev, clock = make_eval(ratio_spec())
    ev.tick(cut=burn_cut(0))
    for n in range(1, 8):                        # burning for 7 straight ticks
        clock.advance(0.5)
        ev.tick(cut=burn_cut(n))
    history = ev.alert_history()
    assert [e.severity for e in history] == ["page"]     # dedup: once, not 7x


def test_downgrade_needs_hysteresis_and_calm_ticks_dont_flap():
    ev, clock = make_eval(ratio_spec())
    ev.tick(cut={"bad": 0.0, "good": 0.0})
    clock.advance(1.0)
    ev.tick(cut={"bad": 50.0, "good": 50.0})
    assert ev.states() == {"avail": "page"}

    # jump past both windows so every further delta is clean
    clock.advance(11.0)
    ev.tick(cut={"bad": 50.0, "good": 1000.0})   # calm verdict -> pending
    assert ev.states() == {"avail": "page"}      # hysteresis: not yet
    clock.advance(0.5)
    ev.tick(cut={"bad": 50.0, "good": 1100.0})   # 0.5s < clear_after 1.0s
    assert ev.states() == {"avail": "page"}
    clock.advance(0.6)
    events = ev.tick(cut={"bad": 50.0, "good": 1200.0})
    assert [e.severity for e in events] == ["ok"]
    assert events[0].previous == "page" and events[0].cleared
    # the full arc is exactly two transitions: fire once, clear once
    assert [e.severity for e in ev.alert_history()] == ["page", "ok"]


def test_refire_during_pending_resets_the_clear_timer():
    ev, clock = make_eval(ratio_spec())
    ev.tick(cut={"bad": 0.0, "good": 0.0})
    clock.advance(1.0)
    ev.tick(cut={"bad": 50.0, "good": 50.0})     # page
    clock.advance(11.0)
    ev.tick(cut={"bad": 50.0, "good": 1000.0})   # calm -> pending clear
    clock.advance(0.8)
    # a fresh burst while the clear is pending: both windows burn again
    ev.tick(cut={"bad": 550.0, "good": 1000.0})
    assert ev.states() == {"avail": "page"}      # still page, no flap
    clock.advance(11.0)
    ev.tick(cut={"bad": 550.0, "good": 9000.0})  # calm again, pending restarts
    clock.advance(0.8)
    ev.tick(cut={"bad": 550.0, "good": 9100.0})  # 0.8s < 1.0s: NOT cleared
    assert ev.states() == {"avail": "page"}
    clock.advance(0.3)
    ev.tick(cut={"bad": 550.0, "good": 9200.0})
    assert ev.states() == {"avail": "ok"}
    assert [e.severity for e in ev.alert_history()] == ["page", "ok"]


def test_warn_then_page_escalates_immediately():
    rules = (BurnRule("page", 10.0, 2.0, burn_threshold=20.0),
             BurnRule("warn", 10.0, 2.0, burn_threshold=5.0))
    ev, clock = make_eval(ratio_spec(rules=rules))
    ev.tick(cut={"bad": 0.0, "good": 0.0})
    clock.advance(1.0)
    ev.tick(cut={"bad": 10.0, "good": 90.0})     # 10% -> burn 10: warn only
    assert ev.states() == {"avail": "warn"}
    clock.advance(0.5)
    ev.tick(cut={"bad": 60.0, "good": 140.0})    # 30% -> burn 30: page NOW
    assert ev.states() == {"avail": "page"}      # upgrade skips hysteresis
    assert [e.severity for e in ev.alert_history()] == ["warn", "page"]


# ------------------------------------------------- fan-out + lifecycle ----

def test_jsonl_stream_and_subscriber_isolation(tmp_path):
    path = tmp_path / "alerts.jsonl"
    spec = ratio_spec()
    clock = FakeClock()
    got = []
    ev = SLOEvaluator(MetricsRegistry(), [spec], clear_after_s=1.0,
                      interval_s=999.0, jsonl_path=str(path), now_fn=clock)
    ev.subscribe(lambda e: got.append(e))
    bad_calls = []
    ev.subscribe(lambda e: (bad_calls.append(e), 1 / 0))   # raising subscriber
    with ev:
        clock.advance(1.0)
        ev.tick(cut={"bad": 0.0, "good": 0.0})
        clock.advance(1.0)
        ev.tick(cut={"bad": 50.0, "good": 50.0})
    assert [e.severity for e in got] == ["page"]
    assert len(bad_calls) == 1
    assert ev.subscriber_errors == 1             # counted, never fatal
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert [rec["severity"] for rec in lines] == ["page"]
    assert set(lines[0]) == {
        "slo", "signal", "kind", "severity", "previous", "burn_rate",
        "window_s", "value", "objective", "t_wall", "message"}
    assert lines[0]["slo"] == "avail" and lines[0]["signal"] == "availability"


def test_status_exposes_burns_and_values():
    ev, clock = make_eval(ratio_spec())
    ev.tick(cut={"bad": 0.0, "good": 0.0})
    clock.advance(1.0)
    ev.tick(cut={"bad": 25.0, "good": 75.0})
    st = ev.status()["avail"]
    assert st["state"] == "page"
    assert st["value"] == pytest.approx(0.25)
    assert st["objective"] == pytest.approx(0.99)
    assert st["burns"]["10s"] == pytest.approx(25.0)


# -------------------------------------------------------------- builders --

def test_serving_slos_replicated_set():
    specs = serving_slos("router", p99_ms=25.0, replicated=True,
                         freshness_bound_s=30.0)
    by_name = {s.name: s for s in specs}
    assert set(by_name) == {"latency_p99", "availability",
                            "replica_availability", "replica_disruption",
                            "generation_lag", "freshness"}
    assert by_name["latency_p99"].threshold_s == pytest.approx(0.025)
    assert by_name["latency_p99"].metric == "router_latency_seconds"
    # every availability-signal spec keys the router's brownout reaction
    avail = [s for s in specs if s.signal == "availability"]
    assert len(avail) == 3
    assert "router_failovers" in by_name["replica_disruption"].bad
    assert by_name["replica_availability"].above_is_error is False
    assert by_name["freshness"].bound == pytest.approx(30.0)


def test_serving_slos_single_gateway_and_mining():
    specs = serving_slos("gateway")
    assert {s.name for s in specs} == {"latency_p99", "availability"}
    assert specs[1].bad == ("gateway_rejected", "gateway_failed")
    (tput,) = mining_slos(rows_per_s_floor=1e4)
    assert tput.kind == "throughput" and tput.floor_per_s == pytest.approx(1e4)


def test_spec_and_rule_validation():
    with pytest.raises(ValueError):
        BurnRule("fatal", 10.0, 2.0, 1.0)        # unknown severity
    with pytest.raises(ValueError):
        BurnRule("page", 2.0, 10.0, 1.0)         # short > long
    with pytest.raises(ValueError):
        SLOSpec(name="x", kind="vibes")
    with pytest.raises(ValueError):
        SLOSpec(name="x", kind="latency", target_ratio=1.0)  # empty budget
    with pytest.raises(ValueError):
        SLOSpec(name="x", kind="latency", rules=())
    with pytest.raises(ValueError):
        SLOEvaluator(MetricsRegistry(), [ratio_spec(), ratio_spec()])


def test_alert_event_round_trips_json():
    ev = AlertEvent(slo="s", signal="latency", kind="latency", severity="warn",
                    previous="ok", burn_rate=3.5, window_s=60.0, value=0.1,
                    objective=0.05, t_wall=123.0, message="m")
    assert AlertEvent(**ev.to_json()) == ev
    assert not ev.cleared

# ======================== regress =======================================
REPO = pathlib.Path(__file__).resolve().parents[1]
COMMITTED = [str(REPO / n) for n in
             ("BENCH_serve.json", "BENCH_fault.json", "BENCH_obs.json")]


# ------------------------------------------------------------ trajectory --

def test_stable_trajectory_passes_and_degraded_fails():
    history = [100.0, 102.0, 98.0, 101.0, 99.0]
    ok, _ = check_trajectory("row", 105.0, history)
    assert ok
    # a tight history gets the floor tolerance (30%): 1.5x is a regression
    ok, detail = check_trajectory("row", 150.0, history)
    assert not ok and "baseline=100" in detail


def test_noisy_history_widens_the_gate():
    noisy = [100.0, 160.0, 70.0, 140.0, 60.0]    # MAD = 40 -> tol = 160%
    ok, _ = check_trajectory("row", 200.0, noisy)
    assert ok                                    # inside the widened gate
    tight = [100.0, 101.0, 99.0, 100.0, 100.0]
    ok, _ = check_trajectory("row", 200.0, tight)
    assert not ok                                # same latest, tight history


def test_young_trajectory_passes_vacuously_and_improvement_always_passes():
    ok, detail = check_trajectory("row", 9e9, [100.0, 100.0])
    assert ok and "no baseline" in detail
    ok, _ = check_trajectory("row", 1.0, [100.0] * 10)
    assert ok                                    # only degradation flags


def test_failed_markers_in_history_are_ignored():
    ok, detail = check_trajectory("row", 100.0, [-1.0, 100.0, 100.0, 100.0])
    assert ok and "n=3" in detail


# ------------------------------------------------------- files + gates ----

def write_bench(tmp_path, name, rows):
    p = tmp_path / name
    p.write_text(json.dumps({"rows": rows}))
    return str(p)


def row(name, us=100.0, history=(100.0, 100.0, 100.0), derived=""):
    return {"name": name, "us_per_call": us, "history": list(history),
            "derived": derived}


def test_check_files_flags_failed_row_and_invariant_violation(tmp_path):
    rows = [
        row("fine"),
        row("regressed", us=1000.0),
        row("crashed", us=-1.0),
        row("serve_gateway_microbatch_c32",
            derived="qps=100;speedup_vs_sequential=1.2x"),   # < 2.0 gate
    ]
    path = write_bench(tmp_path, "b.json", rows)
    inv = {"serve_gateway_microbatch_c32": INVARIANTS["serve_gateway_microbatch_c32"]}
    ok, findings = check_files([path], invariants=inv)
    assert not ok
    bad = {(f.row, f.check) for f in findings if not f.ok}
    assert bad == {("regressed", "trajectory"), ("crashed", "failed_row"),
                   ("serve_gateway_microbatch_c32", "invariant")}
    assert findings[0].ok is False               # violations sort first


def test_missing_gated_row_fails_by_default(tmp_path):
    path = write_bench(tmp_path, "b.json", [row("fine")])
    inv = {"fault_kill_resume_n60000": INVARIANTS["fault_kill_resume_n60000"]}
    ok, findings = check_files([path], invariants=inv)
    assert not ok
    (f,) = [f for f in findings if not f.ok]
    assert f.check == "missing_row" and f.row == "fault_kill_resume_n60000"


def test_invariants_resolve_across_the_union_of_files(tmp_path):
    a = write_bench(tmp_path, "a.json", [row("fine")])
    b = write_bench(tmp_path, "b.json", [
        row("fault_kill_resume_n60000", derived="parity=ok;replayed_levels=0")])
    inv = {"fault_kill_resume_n60000": INVARIANTS["fault_kill_resume_n60000"]}
    ok, _ = check_files([a, b], invariants=inv)
    assert ok


def test_unreadable_file_fails(tmp_path):
    p = tmp_path / "broken.json"
    p.write_text("{nope")
    ok, findings = check_files([str(p)], invariants={})
    assert not ok and findings[0].check == "failed_row"


def test_parse_derived_tolerates_units_and_flat_fragments():
    d = parse_derived("qps=1234;speedup=2.5x;note;hit_rate=80%")
    assert d == {"qps": "1234", "speedup": "2.5x", "hit_rate": "80%"}


# ----------------------------------------------- the committed files ------

def test_committed_trajectories_pass_the_gate():
    """The acceptance criterion: the gate CI runs must be green on the
    repo's own committed trajectory files."""
    ok, findings = check_files(COMMITTED)
    assert ok, [f for f in findings if not f.ok]


def test_synthetically_degraded_committed_copy_fails(tmp_path):
    """...and a 10x-slowed copy of a gated row must NOT be green."""
    data = json.loads((REPO / "BENCH_serve.json").read_text())
    degraded = copy.deepcopy(data)
    for r in degraded["rows"]:
        if r["name"] == "serve_gateway_microbatch_c32":
            # seed enough history that the trajectory gate is armed, then
            # make the latest run 10x slower than that baseline
            r["history"] = [r["us_per_call"]] * 3
            r["us_per_call"] = r["us_per_call"] * 10.0
    p = tmp_path / "BENCH_serve.json"
    p.write_text(json.dumps(degraded))
    ok, findings = check_files([str(p)] + COMMITTED[1:])
    assert not ok
    bad = [f for f in findings if not f.ok]
    assert any(f.row == "serve_gateway_microbatch_c32"
               and f.check == "trajectory" for f in bad)


# ------------------------------------------------------------------- CLI --

def test_cli_exit_codes_and_json_output(tmp_path, capsys):
    good = write_bench(tmp_path, "good.json", [row("fine")])
    assert main(["--check", good]) == 1          # default INVARIANTS missing
    out = capsys.readouterr().out
    assert "missing_row" in out and "FAIL" in out

    assert main(["--check"] + COMMITTED + ["--json"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["ok"] is True
    assert all(f["ok"] for f in rep["findings"])


# ==================== the same output as the JAX package's modules ====================
def _both(attr):
    """(port module, JAX module) of ``repro[_torch].obs.<attr>``."""
    import importlib

    return (importlib.import_module(f"repro_torch.obs.{attr}"),
            importlib.import_module(f"repro.obs.{attr}"))


def _drive_registry(mod, seed):
    rng = np.random.default_rng(seed)
    reg = mod.MetricsRegistry()
    for _ in range(200):
        roll = rng.random()
        labels = {"level": str(int(rng.integers(1, 4)))} if rng.random() < 0.5 else None
        if roll < 0.4:
            reg.counter("requests_total", labels).inc(int(rng.integers(1, 5)))
        elif roll < 0.6:
            g = reg.gauge("queue_depth", labels)
            g.max(float(rng.integers(0, 50))) if rng.random() < 0.5 else g.inc(0.25)
        else:
            reg.histogram("latency_seconds", labels).record(float(rng.lognormal(-6, 1.5)))
    merged = mod.Histogram.merged([reg.histogram("latency_seconds"),
                                   reg.histogram("latency_seconds", {"level": "1"})])
    return reg, merged


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_snapshot_json_equals_jax(seed):
    (tmod, jmod) = _both("registry")
    treg, tm = _drive_registry(tmod, seed)
    jreg, jm = _drive_registry(jmod, seed)
    assert json.dumps(treg.snapshot(), sort_keys=True) == json.dumps(jreg.snapshot(), sort_keys=True)
    assert treg.to_prometheus() == jreg.to_prometheus()
    assert tm.snapshot() == jm.snapshot()
    assert [tm.quantile(q) for q in (0.5, 0.9, 0.99)] == [jm.quantile(q) for q in (0.5, 0.9, 0.99)]


class _FakeTime:
    """A stand-in for the ``time`` module: perf_counter steps 1 ms a call."""

    def __init__(self):
        self.t = 100.0

    def perf_counter(self):
        self.t += 0.001
        return self.t

    def time(self):
        return 1.7e9 + self.t

    def time_ns(self):
        return 1_700_000_000_000_000_000


def _drive_tracer(mod):
    tr = mod.Tracer(sample_rate=0.5)
    for i in range(6):
        root = tr.root("router.request", basket=i)
        child = tr.child(root, "gateway.request", top_k=5)
        with tr.span(child, "queue.wait"):
            pass
        tr.add_span(child, "device.dispatch", 100.5 + i, 100.6 + i, bucket=8)
        if child is not None:
            child.end(outcome="ok")
        if root is not None:
            root.end()
    tr.root("swap.prepare", force=True, generation=1).end()
    return tr


def test_chrome_trace_events_equal_jax(monkeypatch):
    """The same spans export as the JAX package's events, on the port's
    clock: ``ts`` moved by the tracer's Unix-epoch anchor (the clock of
    ``torch.profiler``'s trace) and both ``ts`` and ``dur`` whole µs."""
    tmod, jmod = _both("trace")
    monkeypatch.setattr(tmod, "time", _FakeTime())
    monkeypatch.setattr(jmod, "time", _FakeTime())
    t, j = _drive_tracer(tmod), _drive_tracer(jmod)
    assert t.sampled_roots == j.sampled_roots == 3
    shift = t.epoch_unix_ns / 1e3
    want = j.export_chrome()
    want["traceEvents"] = [dict(e, ts=round(shift + e["ts"]), dur=round(e["dur"])) if e["ph"] == "X" else e
                           for e in want["traceEvents"]]
    assert json.dumps(t.export_chrome(), sort_keys=True) == json.dumps(want, sort_keys=True)


def _drive_slo(mod, clock_start=0.0):
    from types import SimpleNamespace

    slo, reg = mod
    clock = SimpleNamespace(t=clock_start)
    rules = (slo.BurnRule("page", long_window_s=10.0, short_window_s=2.0, burn_threshold=10.0),
             slo.BurnRule("warn", long_window_s=30.0, short_window_s=5.0, burn_threshold=3.0))
    specs = slo.serving_slos("router", p99_ms=50.0, replicated=True, rules=rules)
    ev = slo.SLOEvaluator(reg.MetricsRegistry(), specs, clear_after_s=1.0, now_fn=lambda: clock.t)
    rng = np.random.default_rng(5)
    good = bad = 0.0
    events = []
    for step in range(120):
        storm = 30 <= step < 50
        good += float(rng.integers(50, 100))
        bad += float(rng.integers(20, 40)) if storm else 0.0
        cut = {"router_completed": good, "router_failed": bad, "router_routed": good + bad,
               "router_healthy_replica_ratio": 0.5 if storm else 1.0}
        events += ev.tick(cut=cut)
        clock.t += 0.5
    return [{k: v for k, v in e.to_json().items() if k != "t_wall"} for e in events], ev.status()


def test_alert_transitions_equal_jax_on_injected_clock():
    import importlib

    port = (importlib.import_module("repro_torch.obs.slo"), importlib.import_module("repro_torch.obs.registry"))
    ref = (importlib.import_module("repro.obs.slo"), importlib.import_module("repro.obs.registry"))
    t_events, t_status = _drive_slo(port)
    j_events, j_status = _drive_slo(ref)
    assert t_events == j_events
    assert any(e["severity"] == "page" for e in t_events)
    assert any(e["severity"] == "ok" for e in t_events)
    assert t_status == j_status


def test_regress_verdicts_equal_jax(tmp_path):
    tmod, jmod = _both("regress")
    rng = np.random.default_rng(3)
    for _ in range(40):
        hist = [float(x) for x in rng.lognormal(4, rng.choice([0.05, 0.5]), int(rng.integers(0, 7)))]
        latest = float(rng.lognormal(4, 0.6))
        assert tmod.check_trajectory("row", latest, hist) == jmod.check_trajectory("row", latest, hist)
    # the committed bench files, and a copy with one gate row degraded
    paths = list(COMMITTED)
    doc = json.loads(pathlib.Path(COMMITTED[0]).read_text())
    bad = copy.deepcopy(doc)
    bad["rows"][0]["us_per_call"] = -1.0
    bad["rows"][1]["us_per_call"] *= 10.0
    bad_path = tmp_path / "BENCH_bad.json"
    bad_path.write_text(json.dumps(bad))
    for ps in (paths, [str(bad_path)] + paths[1:]):
        t_ok, t_find = tmod.check_files(ps)
        j_ok, j_find = jmod.check_files(ps)
        assert t_ok == j_ok
        assert [f.to_json() for f in t_find] == [f.to_json() for f in j_find]
    assert tmod.INVARIANTS == jmod.INVARIANTS


def test_mining_counters_equal_jax(store):
    """The port's streamed mine and the JAX package's, each observed by
    its own MiningObs, count the same levels, candidates, frequent
    itemsets, chunks and rows (the phase seconds are each run's own); the
    port's counters, less its named additions (``port_only_counters``),
    are the JAX package's."""
    from repro.core.apriori import AprioriConfig as JConfig
    from repro.core.streaming import mine_streamed as jmine_streamed
    from repro.data.store import open_store as jopen_store
    from repro.obs import MetricsRegistry as JRegistry
    from repro.obs import MiningObs as JMiningObs

    tobs = MiningObs(registry=MetricsRegistry())
    jobs = JMiningObs(registry=JRegistry())
    cfg = AprioriConfig(min_support=0.02, max_k=3, representation="packed")
    mine_streamed(store, cfg, chunk_rows=512, obs=tobs)
    jmine_streamed(jopen_store(store.path), JConfig(min_support=0.02, max_k=3, count_impl="jnp",
                                                    representation="packed"),
                   chunk_rows=512, obs=jobs)
    t, j = tobs.counters(), jobs.counters()
    extra = port_only_counters(t)
    assert sorted(set(t) - extra) == sorted(j) and extra <= set(t)
    timed = {k for k in t if k.startswith("mine_phase_seconds")}
    assert {k: t[k] for k in t if k not in timed | extra} == {k: j[k] for k in j if k not in timed}


# ======================== the port's own spans ==========================
def test_compile_phases_sum_to_at_most_compile_and_place_wall(small_db):
    from repro_torch.core.apriori import mine
    from repro_torch.serving.rulebook import compile_rulebook, place_rulebook

    res = mine(small_db, AprioriConfig(min_support=0.05, max_k=3, representation="packed"), device="cpu")
    obs = MiningObs()
    t0 = time.perf_counter()
    rb = place_rulebook(compile_rulebook(res, min_confidence=0.3, num_items=32, obs=obs), "cpu", obs=obs)
    wall = time.perf_counter() - t0
    assert rb.num_rules > 0
    c = obs.counters()
    sec = [c[f'mine_phase_seconds{{phase="{p}"}}'] for p in ("rules_extract", "rules_sort", "rules_pad",
                                                              "rulebook_place")]
    assert all(s > 0.0 for s in sec) and sum(sec) <= wall


def _profiled_spans(tmp_path):
    """A live span, a back-dated span and a mining phase under a CPU
    profiler: (the profiler's user annotations by name, the tracer's events
    by name, the profiler's base in µs)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs.mining import phase

    tr = Tracer(sample_rate=1.0)
    obs = MiningObs(tracer=tr)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        root = tr.root("test.root")
        with tr.span(root, "test.live"):
            time.sleep(0.003)
        tr.add_span(root, "test.backdated", time.perf_counter() - 0.001, time.perf_counter())
        root.end()
        with phase(obs, "candidate_prune"):
            time.sleep(0.002)
    obs.finish()
    prof.export_chrome_trace(str(tmp_path / "prof.json"))
    trace = json.loads((tmp_path / "prof.json").read_text())
    marks = {e["name"]: e for e in trace["traceEvents"] if e.get("cat") == "user_annotation"}
    ours = {e["name"]: e for e in tr.export_chrome()["traceEvents"] if e["ph"] == "X"}
    return marks, ours, trace["baseTimeNanoseconds"] / 1e3


def test_program_spans_are_profiler_annotations_on_its_clock(tmp_path):
    """While ``torch.profiler`` records, a live span and a mining phase are
    ``user_annotation`` ranges of their names, and the tracer's exported
    ``ts`` is the profiler's (``ts`` + ``baseTimeNanoseconds`` / 1e3)
    within 1 ms.  Back-dated spans are not mirrored.  Up to three profiles
    are taken: beside busy test workers the profiler's own conversion to
    Unix time was seen to read 1-5 ms late in one profile."""
    gaps = []
    for _ in range(3):
        marks, ours, base = _profiled_spans(tmp_path)
        assert {"test.live", "mine.candidate_prune"} <= set(marks) and "test.backdated" not in marks
        assert {"test.root", "test.live", "test.backdated", "mine.job", "mine.candidate_prune"} <= set(ours)
        for name in ("test.live", "mine.candidate_prune"):
            assert isinstance(ours[name]["ts"], int) and isinstance(ours[name]["dur"], int)
        gaps.append(max(abs(marks[n]["ts"] + base - ours[n]["ts"]) for n in ("test.live", "mine.candidate_prune")))
        if gaps[-1] < 1000.0:
            break
    assert min(gaps) < 1000.0, gaps


def test_spans_pay_no_profiler_range_without_a_profiler(monkeypatch):
    """With no profiler recording, a live span and a phase never build a
    ``record_function``."""
    from repro_torch.obs import trace as tmod
    from repro_torch.obs.mining import phase

    monkeypatch.setattr(tmod.torch.profiler, "record_function", None)   # building one would raise
    tr = Tracer(sample_rate=1.0)
    obs = MiningObs(tracer=tr)
    root = tr.root("test.root")
    with tr.span(root, "test.live"):
        pass
    with phase(obs, "candidate_join"):
        pass
    with phase(None, "candidate_join"):
        pass
    root.end()
    assert {s.name for s in tr.spans()} == {"test.root", "test.live"}
