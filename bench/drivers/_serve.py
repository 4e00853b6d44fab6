"""What the serving drivers share: the rulebook mined at set-up, the
gateway, the fresh baskets, the window's bookkeeping and the check."""

from __future__ import annotations

import os
import threading
import time

import numpy as np

from bench import checks, common
from bench.reference import mine as ref_mine
from bench.reference import rules as ref_rules

TRACE_SAMPLE = 0.05    # share of requests the gateway's tracer follows in a traced run
TRACE_SPANS = 1 << 15  # spans it keeps


def setup(ctx, baskets: int):
    """Mine and compile the rulebook by the configuration's set-up route,
    start the gateway on it, warm it, and make ``baskets`` fresh baskets."""
    from repro_torch.core import streaming
    from repro_torch.serving.gateway import Gateway
    from repro_torch.serving.rulebook import compile_rulebook

    cfg, tr = ctx.config, ctx.traffic
    dense = common.dataset(cfg)
    route = cfg["setup_mine"]
    if route["route"] != "stream":
        raise ValueError(f"serving set-up mines by the stream route, got {route['route']!r}")
    store = common.write_store(dense, os.path.join(ctx.tmp, "store"), int(route["shard_rows"]))
    t = time.perf_counter()
    res = streaming.mine_streamed(store, common.apriori_config(cfg, route), device=ctx.device,
                                  chunk_rows=int(route["chunk_rows"]))
    m = cfg["mining"]
    rb = compile_rulebook(res, min_confidence=m["min_confidence"], score=m["score"],
                          num_items=cfg["data"]["num_items"])
    mine_s = time.perf_counter() - t
    tracer = None
    if ctx.trace:
        from repro_torch.obs import Tracer

        tracer = Tracer(sample_rate=TRACE_SAMPLE, capacity=TRACE_SPANS)
    s = cfg["serving"]
    gw = Gateway(rb, device=ctx.device, top_k=s["top_k"], max_batch=s["max_batch"], max_wait_ms=s["max_wait_ms"],
                 queue_depth=s["queue_depth"], cache_capacity=s["cache"], warmup=s["warmup"], tracer=tracer)
    warm = common.pack(common.fresh_baskets(cfg, ctx.rng_seed(3), int(tr.get("warm_requests", 256))))
    for f in [gw.submit(b) for b in warm]:
        f.result(timeout=60)
    packed = common.pack(common.fresh_baskets(cfg, ctx.rng_seed(2), baskets))
    ctx.log(f"[setup] mined {res.total_frequent} itemsets, {rb.num_rules} rules in {mine_s:.3f} s; "
            f"{baskets} fresh baskets")
    return dict(dense=dense, gateway=gw, baskets=packed, tracer=tracer, rules=rb.num_rules,
                levels={int(k): int(v[0].shape[0]) for k, v in sorted(res.levels.items())}, mine_s=mine_s)


class Book:
    """Per request: when it was due, sent and answered, and the answer.

    Filled by the window's one load thread and the gateway's done
    callbacks.  Everything is kept in preallocated arrays, and a future is
    let go once it is answered, so the book adds no objects to the heap as
    the window goes on (a heap that grows makes the interpreter's garbage
    collector stop the process for longer and longer)."""

    def __init__(self, n: int, top_k: int = 10):
        self.due = np.zeros(n)
        self.sent = np.zeros(n)
        self.done = np.full(n, np.nan)
        self.ok = np.zeros(n, dtype=bool)
        self.rejected = np.zeros(n, dtype=bool)
        self.items = np.zeros((n, top_k), dtype=np.int32)
        self.scores = np.zeros((n, top_k), dtype=np.float32)
        self.open: dict = {}
        self.count = 0
        self.answered = 0
        self._lock = threading.Lock()
        self._all_done = threading.Condition(self._lock)

    def send(self, gw, i: int, basket, due: float, notify=None) -> bool:
        """Submit request ``i``; False if the gateway rejected it.
        ``notify(i)`` runs when its answer comes."""
        from repro_torch.serving.batcher import AdmissionRejected

        self.due[i] = due
        self.sent[i] = time.perf_counter()
        self.count = max(self.count, i + 1)
        try:
            fut = gw.submit(basket)
        except AdmissionRejected:
            self.rejected[i] = True
            return False
        with self._lock:
            self.open[i] = fut
        fut.add_done_callback(lambda f, i=i: self._answered(f, i, notify))
        return True

    def _answered(self, fut, i: int, notify) -> None:
        self.done[i] = time.perf_counter()
        if fut.exception() is None:
            r = fut.result()
            k = len(r.items)
            self.items[i, :k], self.scores[i, :k] = r.items, r.scores
            self.ok[i] = True
        with self._lock:
            self.open.pop(i, None)
            self.answered += 1
            self._all_done.notify_all()
        if notify is not None:
            notify(i)

    def drain(self, seconds: float) -> None:
        """Wait up to ``seconds`` for the requests still open."""
        end = time.perf_counter() + seconds
        with self._lock:
            while self.open and time.perf_counter() < end:
                self._all_done.wait(timeout=max(0.0, end - time.perf_counter()))

    def outcome(self) -> dict:
        """Latency of each request from its due time (failed, rejected and
        unanswered ones at :data:`common.FAILED_LATENCY_S`) and the counts."""
        n = self.count
        ok = self.ok[:n].copy()
        lat = np.where(ok, self.done[:n] - self.due[:n], common.FAILED_LATENCY_S)
        with self._lock:
            unanswered = len(self.open)
        return dict(latency=lat, ok=ok, rejected=int(self.rejected[:n].sum()), unanswered=unanswered,
                    failed=int(n - ok.sum()))


def counters(gw) -> dict:
    snap = gw.metrics.snapshot()
    return {k: snap[k] for k in ("batches", "batch_rows_real", "batch_rows_padded", "cache_hits", "completed")}


def window_spans(tracer, t0: float, t1: float) -> dict:
    """Seconds of the gateway's sampled spans by name, ended inside [t0, t1]."""
    out: dict = {}
    if tracer is None:
        return out
    for sp in tracer.spans():
        if sp.t1 is not None and t0 <= sp.t1 <= t1:
            out.setdefault(sp.name, []).append(sp.t1 - sp.t0)
    return out


def check(state, result, ctx):
    """A sample of the answered requests, drawn from the seed with the
    longest baskets in it, against the reference's answers worked out from
    the data set and the baskets themselves."""
    gw = state["gateway"]
    book: Book = result["book"]
    gw.close()
    tr = ctx.traffic
    answered = np.flatnonzero(result["outcome"]["ok"])
    rng = np.random.default_rng(ctx.rng_seed(4))
    pick = common.sample(rng, answered.size, int(tr.get("check_sample", 4096)))
    chosen = answered[pick]
    pool = state["baskets"]   # request i carried basket i % len(pool)
    lengths = np.unpackbits(pool[answered % len(pool)].view(np.uint8), axis=1).sum(1)
    longest = answered[np.argsort(-lengths, kind="stable")[: int(tr.get("check_longest", 64))]]
    chosen = np.union1d(chosen, longest).astype(np.int64)
    items, scores = book.items[chosen], book.scores[chosen]
    state["gateway"] = None
    if ctx.device == "cuda":
        import torch

        torch.cuda.empty_cache()
    t = time.perf_counter()
    cfg, m = ctx.config, ctx.config["mining"]
    ref = ref_mine.frequent_itemsets(state["dense"], m["min_support"], m["max_k"], device=ctx.device)
    rb = ref_rules.rules(ref, m["min_confidence"], cfg["data"]["num_items"])
    num_items = cfg["data"]["num_items"]
    baskets = _unpack(pool[chosen % len(pool)], num_items)
    ref_scores = ref_rules.item_scores(rb, baskets, num_items, device=ctx.device).cpu().numpy()
    score_gap, rank_gap, malformed = checks.answer_gaps(items, scores, ref_scores)
    answer_gap = max(score_gap, rank_gap)
    result["reference"] = dict(rules=len(rb["score"]),
                               ante_words=int(np.count_nonzero(rb["ante"])),
                               words=int(rb["ante"].shape[1]))
    result["detail"].update(reference_s=time.perf_counter() - t, compared=int(chosen.size),
                            reference_rules=len(rb["score"]), score_gap=score_gap, rank_gap=rank_gap)
    return [("unanswered", result["outcome"]["unanswered"], 0),
            ("malformed", malformed, 0),
            ("answer_gap", answer_gap, ctx.limits["answer_gap"])]


def _unpack(packed: np.ndarray, num_items: int) -> np.ndarray:
    bits = np.unpackbits(packed.view(np.uint8), axis=1, bitorder="little")
    return bits[:, :num_items].astype(np.int8)
