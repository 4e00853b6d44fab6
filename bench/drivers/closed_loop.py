"""An upstream service: a fixed pool of ``workers``, each waiting for its
answer before it sends its next request.

One load thread keeps ``workers`` requests open: each answer (taken from the
gateway's done callbacks) releases its worker, which sends the next fresh
basket at once while the window lasts.  The baskets are a pool of
``baskets_per_s x seconds`` fresh transactions, taken in turn (a faster
program than that repeats them, far past the basket cache's reach).
``serve_qps`` is the requests answered inside the window over its seconds.
After the window the driver waits ``drain_s`` for the requests still open.
A traced run profiles the window's first ``trace_seconds``; the window
steps over the profiler's stop.
"""

from __future__ import annotations

import queue
import time

import numpy as np

from bench import common
from bench.drivers import _serve


def setup(ctx):
    tr = ctx.traffic
    pool = int(float(tr["baskets_per_s"]) * ctx.seconds) + int(tr["workers"])
    return _serve.setup(ctx, pool)


def window(state, ctx):
    tr = ctx.traffic
    gw, baskets = state["gateway"], state["baskets"]
    workers = int(tr["workers"])
    book = _serve.Book(int(float(tr["max_per_s"]) * ctx.seconds) + workers, int(ctx.config["serving"]["top_k"]))
    answers: queue.SimpleQueue = queue.SimpleQueue()
    trace_s = float(tr.get("trace_seconds", 5.0))
    traced = None
    if ctx.trace:
        ctx.profiler.start()
    c0 = _serve.counters(gw)
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    nxt = 0
    open_ = 0
    for _ in range(workers):
        open_ += book.send(gw, nxt, baskets[nxt % len(baskets)], time.perf_counter(), answers.put)
        nxt += 1
    while time.perf_counter() < deadline and nxt < len(book.due):
        if open_ == 0:
            break
        try:
            answers.get(timeout=max(0.0, deadline - time.perf_counter()))
        except queue.Empty:
            break
        open_ -= 1
        while open_ < workers and time.perf_counter() < deadline and nxt < len(book.due):
            open_ += book.send(gw, nxt, baskets[nxt % len(baskets)], time.perf_counter(), answers.put)
            nxt += 1
        if ctx.trace and traced is None and time.perf_counter() - t0 >= trace_s:
            t1 = time.perf_counter()
            traced = (t1, _serve.counters(gw), _serve.window_spans(state["tracer"], t0, t1))
            ctx.profiler.stop()
            deadline += time.perf_counter() - traced[0]   # the profiler's stop is the benchmark's
    if ctx.trace and traced is None:
        t1 = time.perf_counter()
        traced = (t1, _serve.counters(gw), _serve.window_spans(state["tracer"], t0, t1))
        ctx.profiler.stop()
    t_end = max(time.perf_counter(), deadline)
    c1 = _serve.counters(gw)
    book.drain(float(tr.get("drain_s", 10.0)))
    out = book.outcome()
    done = book.done[: book.count]
    answered_in = int(np.sum(out["ok"] & (done <= deadline)))
    lat = out["latency"]
    detail = dict(requests=book.count, workers=workers, answered_in_window=answered_in,
                  pool=len(baskets), repeated=max(0, book.count - len(baskets)),
                  p50_ms=1e3 * common.quantile(lat, 0.5), p99_ms=1e3 * common.quantile(lat, 0.99),
                  rejected=out["rejected"], unanswered=out["unanswered"], failed=out["failed"],
                  batches=c1["batches"] - c0["batches"], rows_real=c1["batch_rows_real"] - c0["batch_rows_real"],
                  cache_hits=c1["cache_hits"] - c0["cache_hits"], rules=state["rules"], levels=state["levels"],
                  setup_mine_s=state["mine_s"], window_s=t_end - t0)
    result = dict(metrics={"serve_qps": (answered_in / ctx.seconds, "queries/s")}, attempted=book.count,
                  failed=out["failed"], book=book, outcome=out, detail=detail)
    if traced is not None:
        _, ct, spans = traced
        result.update(spans=spans, traced_batches=ct["batches"] - c0["batches"],
                      traced_rows=ct["batch_rows_real"] - c0["batch_rows_real"])
    return result


def check(state, result, ctx):
    return _serve.check(state, result, ctx)
