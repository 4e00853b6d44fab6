"""Independent shoppers: cart queries at a fixed rate, whatever the answers.

Arrivals are a Poisson process at ``rate_per_s``, drawn from the seed; each
request is a fresh basket of the configuration's data set sent once.  One
load thread sleeps to each due time and submits (a late generator sends at
once, to catch up), and each request is timed from its due time to its
answer, so a stall shows in every request that waited behind it.  After
the window the driver waits ``drain_s`` for the requests still open; a
request that failed, was rejected or got no answer counts as slower than
any answer.  ``serve_p99_ms`` is the 99th percentile over every request due
in the window.  A traced run profiles the window's first
``trace_seconds``.
"""

from __future__ import annotations

import time

import numpy as np

from bench import common
from bench.drivers import _serve


def setup(ctx):
    rate = float(ctx.traffic["rate_per_s"])
    rng = np.random.default_rng(ctx.rng_seed(5))
    n = int(rate * ctx.seconds + 10 * np.sqrt(rate * ctx.seconds) + 100)
    due = np.cumsum(rng.exponential(1.0 / rate, n))
    due = due[due < ctx.seconds]
    state = _serve.setup(ctx, due.size)
    state["due"] = due
    return state


def run_schedule(gw, due: np.ndarray, baskets: np.ndarray, seconds: float, drain_s: float, on_trace=None,
                 trace_s: float = 0.0, top_k: int = 10) -> dict:
    """Send ``baskets[i]`` at ``due[i]`` seconds into a window of ``seconds``,
    then wait up to ``drain_s`` for the answers.  ``on_trace()``, if given,
    is called once ``trace_s`` into the window (the traced part ends) and
    returns what it read then; the schedule after it moves on by the time
    the call took (the profiler's stop is the benchmark's, not the
    program's)."""
    book = _serve.Book(due.size, top_k)
    traced = None
    c0 = _serve.counters(gw)
    t0 = time.perf_counter()
    offset = 0.0   # the profiler's stop, which the schedule steps over
    for i in range(due.size):
        target = t0 + offset + due[i]
        wait = target - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        book.send(gw, i, baskets[i], target)
        if on_trace is not None and traced is None and time.perf_counter() - t0 >= trace_s:
            t_stop = time.perf_counter()
            traced = on_trace()
            offset += time.perf_counter() - t_stop
    if on_trace is not None and traced is None:
        traced = on_trace()
    rest = t0 + offset + seconds - time.perf_counter()
    if rest > 0:
        time.sleep(rest)
    t_end = time.perf_counter()
    c1 = _serve.counters(gw)
    book.drain(drain_s)
    out = book.outcome()
    n = book.count
    late = book.sent[:n] - book.due[:n]
    lat = out["latency"]
    done = np.where(np.isnan(book.done[:n]), np.inf, book.done[:n])
    taken = ~book.rejected[:n]
    marks = [t0 + offset + f * seconds for f in (0.25, 0.5, 0.75, 1.0)]
    backlog = [int(np.sum(taken & (book.sent[:n] <= m)) - np.sum(done <= m)) for m in marks]
    stats = dict(requests=n, offered_per_s=n / seconds,
                 answered_per_s=int(np.sum(out["ok"] & (done <= t_end))) / (t_end - t0 - offset),
                 p50_ms=1e3 * common.quantile(lat, 0.5), p90_ms=1e3 * common.quantile(lat, 0.9),
                 p99_ms=1e3 * common.quantile(lat, 0.99),
                 max_ok_ms=1e3 * float(np.max(lat[out["ok"]], initial=0.0)),
                 rejected=out["rejected"], unanswered=out["unanswered"], failed=out["failed"],
                 late_p50_ms=1e3 * common.quantile(late, 0.5), late_p99_ms=1e3 * common.quantile(late, 0.99),
                 late_max_ms=1e3 * float(np.max(late, initial=0.0)), backlog=backlog,
                 batches=c1["batches"] - c0["batches"], rows_real=c1["batch_rows_real"] - c0["batch_rows_real"],
                 cache_hits=c1["cache_hits"] - c0["cache_hits"])
    return dict(book=book, outcome=out, t0=t0, c0=c0, traced=traced, stats=stats)


def window(state, ctx):
    gw = state["gateway"]
    on_trace = None
    if ctx.trace:
        ctx.profiler.start()
        t_start = time.perf_counter()

        def on_trace():
            # what the traced part read, taken as it ends (the tracer's ring
            # keeps the newest spans only)
            t1 = time.perf_counter()
            read = (t1, _serve.counters(gw), _serve.window_spans(state["tracer"], t_start, t1))
            ctx.profiler.stop()
            return read

    run = run_schedule(gw, state["due"], state["baskets"], ctx.seconds, float(ctx.traffic.get("drain_s", 10.0)),
                       on_trace, float(ctx.traffic.get("trace_seconds", 5.0)), int(ctx.config["serving"]["top_k"]))
    st = run["stats"]
    detail = dict(st, rate_per_s=float(ctx.traffic["rate_per_s"]), rules=state["rules"], levels=state["levels"],
                  setup_mine_s=state["mine_s"])
    result = dict(metrics={"serve_p99_ms": (st["p99_ms"], "ms")}, attempted=st["requests"], failed=st["failed"],
                  book=run["book"], outcome=run["outcome"], detail=detail)
    if run["traced"] is not None:
        _, ct, spans = run["traced"]
        c0 = run["c0"]
        result.update(spans=spans, traced_batches=ct["batches"] - c0["batches"],
                      traced_rows=ct["batch_rows_real"] - c0["batch_rows_real"])
    return result


def check(state, result, ctx):
    return _serve.check(state, result, ctx)
