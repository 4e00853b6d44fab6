"""Online serving gateway: queue → bucketizer → match step → demux (§10).

The gateway turns the batch engine (`serving/recommend.py`) into an online
query service. Independent clients call :meth:`Gateway.submit` (or the
blocking :meth:`Gateway.query`) with ONE basket each; the micro-batcher
(`serving/batcher.py`) coalesces concurrent arrivals, the gateway pads each
coalesced group to a power-of-two bucket, runs the SAME match step (the K2
kernel through ``kernels.ops.rule_match``) + top-k step the batch engine
uses — so a gateway response is bit-identical to a direct
:func:`~repro_torch.serving.recommend.recommend` call against the answering
rulebook — and demultiplexes per-request :class:`Response` futures.

**Generations + hot-swap.** The servable rulebook is wrapped in an immutable
generation record ``(generation id, device-placed rulebook)`` behind a single
reference. :meth:`hot_swap` device-places and warms the incoming rulebook
FIRST (double-buffered: both generations resident), waits for its copies to
land on the card, then replaces the reference — one atomic store. Every
dispatch grabs the reference exactly once, so a batch is answered wholly by
one generation and every :class:`Response` carries the ``generation`` that
answered it; in-flight and queued requests are never dropped by a swap,
they simply resolve against whichever generation their dispatch grabbed. The old generation's device
tensors free when the last in-flight batch referencing them completes.

**Cache.** An exact-basket LRU (`serving/cache.py`) keyed on
``(packed words, top_k, generation)`` answers repeat baskets without
queueing; the generation in the key makes stale hits impossible after a
swap. All counters land in `serving/metrics.py`.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

from repro_torch.core import itemsets as enc
from repro_torch.device import resolve_device
from repro_torch.serving.batcher import AdmissionRejected, MicroBatcher, Request
from repro_torch.serving.cache import BasketCache, basket_key
from repro_torch.serving.metrics import GatewayMetrics
from repro_torch.serving.recommend import _to_device, _to_host, _topk_items, make_match_step, pack_baskets
from repro_torch.serving.rulebook import Rulebook, place_rulebook


@dataclasses.dataclass
class Response:
    """One answered basket query."""

    items: np.ndarray      # (top_k,) int32 recommended item ids
    scores: np.ndarray     # (top_k,) float32 evidence (-inf = beyond scoreable)
    generation: int        # rulebook generation that answered
    cached: bool           # served from the exact-basket cache
    latency_s: float       # submit -> response
    bucket: int            # padded bucket of the answering dispatch: the
                           # response is bit-identical to recommend(...,
                           # batch_size=bucket) against this generation (§10)


class _Generation:
    """Immutable (id, device-placed rulebook) pair — the swap unit."""

    __slots__ = ("generation", "rulebook")

    def __init__(self, generation: int, rulebook: Rulebook):
        self.generation = generation
        self.rulebook = rulebook


def pow2_bucket(n: int, max_batch: int, multiple: int = 1) -> int:
    """Smallest power-of-two >= n (clamped to max_batch), rounded up to
    ``multiple`` — the bucket ladder: O(log max_batch) launch shapes
    regardless of arrival pattern."""
    if n < 1 or n > max_batch:
        raise ValueError(f"batch of {n} outside [1, {max_batch}]")
    b = 1 << (n - 1).bit_length()
    b = min(b, max_batch)
    b = max(b, n)                       # max_batch itself may not be a pow2
    return ((b + multiple - 1) // multiple) * multiple


class Gateway:
    """Micro-batched online query service over a hot-swappable rulebook."""

    def __init__(
        self,
        rulebook: Rulebook,
        *,
        device="cuda",
        impl: str = "auto",
        top_k: int = 10,
        exclude_basket: bool = True,
        max_batch: int = 64,
        max_wait_ms: float = 1.0,
        p99_target_ms: float | None = None,
        queue_depth: int = 1024,
        cache_capacity: int = 4096,
        warmup: bool | str = True,
        tracer=None,
        trace_root: bool = True,
    ):
        """``device``: where the rulebook lives and every match runs
        (``"cuda"`` by default; raises without CUDA unless ``"cpu"``).

        ``warmup``: ``True`` runs the bucket-ladder endpoints (1 and
        ``max_batch``) once per generation before it serves; ``"ladder"``
        runs every power-of-two bucket; ``False`` warms lazily on first
        use.  The first warm launch builds the kernel library; the rest
        fill the caching allocator with each bucket's buffers, off the
        serving path.

        ``p99_target_ms``: enables the p99-targeted adaptive straggler wait
        (§14): ``max_wait_ms`` becomes the wait CEILING (and starting point)
        and a bounded-AIMD controller shrinks the wait whenever the windowed
        latency p99 burns past the target — the adaptive gateway never waits
        longer than the fixed configuration, it only gets out of the way
        faster. ``None`` keeps the classic fixed wait.

        ``tracer``: optional :class:`repro_torch.obs.Tracer`; sampled requests get
        cache-probe / queue-wait / batch-assembly / device-dispatch spans.
        ``trace_root=False`` (the router's replicas) makes the gateway only
        ever CONTINUE a trace handed in by its caller, never start one —
        sampling then happens once, at the router."""
        self.num_items = rulebook.num_items
        self.default_top_k = min(top_k, self.num_items)
        self.exclude_basket = exclude_basket
        self.max_batch = int(max_batch)
        self._words = enc.packed_words(self.num_items)
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._warmup_enabled = warmup
        self._tracer = tracer
        self._trace_root = bool(trace_root)
        self._closed = False

        # the SAME match step recommend() uses: gateway and batch engine
        # answer a basket bit for bit alike
        self._step = make_match_step(impl=impl)

        self.metrics = GatewayMetrics()
        self.cache = BasketCache(cache_capacity)
        self._swap_lock = threading.RLock()
        self._generation = self._place(0, rulebook)
        self.metrics.mark_generation_commit()   # freshness clock starts now
        if warmup:
            self._warm(self._generation)
        self.wait_controller = None
        if p99_target_ms is not None:
            from repro_torch.serving.controller import AdaptiveMaxWait

            self.wait_controller = AdaptiveMaxWait(
                self.metrics.latency,
                objective_ms=float(p99_target_ms),
                initial_wait_ms=max_wait_ms,   # ceiling == the fixed config
                max_wait_ms=max_wait_ms,
            )
        self._batcher = MicroBatcher(
            self._dispatch,
            max_batch=max_batch,
            max_wait_ms=max_wait_ms,
            queue_depth=queue_depth,
            metrics=self.metrics,
            wait_controller=self.wait_controller,
        )

    # ---------------------------------------------------------- lifecycle --
    def close(self) -> None:
        """Stop admitting; every already-admitted request still resolves."""
        self._closed = True
        self._batcher.close()

    def __enter__(self) -> "Gateway":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    # ----------------------------------------------------------- requests --
    def submit(self, basket, top_k: int | None = None, deadline_ms: float | None = None,
               _span_parent=None):
        """Admit one basket query; returns a Future[:class:`Response`].

        ``basket``: item-id list/tuple/1-D int array, or a pre-packed (W,)
        uint32 bitset row. Raises :class:`AdmissionRejected` when the queue
        is full or the gateway is closed — overload is reported, not
        silently dropped. ``deadline_ms`` bounds the REQUEST, not just the
        caller's wait: a request still queued when its deadline passes is
        dropped at dispatch time with
        :class:`~repro_torch.serving.batcher.DeadlineExceeded` instead of
        spending device time on abandoned work.

        ``_span_parent``: internal — a router attempt span this request
        should continue (the cross-layer trace-context propagation, §13).
        """
        if self._closed:
            self.metrics.record_admission(False)
            raise AdmissionRejected("gateway closed")
        k = min(self.default_top_k if top_k is None else int(top_k), self.num_items)
        packed = self._pack_one(basket)
        t0 = time.perf_counter()

        span = None
        if self._tracer is not None:
            if _span_parent is not None:
                span = self._tracer.child(_span_parent, "gateway.request", top_k=k)
            elif self._trace_root:
                span = self._tracer.root("gateway.request", top_k=k)
            if span is not None:
                span.t0 = t0   # backdate to submit entry so cache.probe
                               # and queue.wait nest inside this span

        gen = self._generation
        hit = self.cache.get(basket_key(packed, k, gen.generation), count=False)
        if span is not None:
            self._tracer.add_span(span, "cache.probe", t0, time.perf_counter(),
                                  hit=hit is not None)
        if hit is not None:
            items, scores, answered_by, bucket = hit
            latency = time.perf_counter() - t0
            self.cache.record(True)
            self.metrics.record_cache(True)
            self.metrics.record_admission(True)
            self.metrics.record_response(latency)
            fut = Future()
            fut.set_result(Response(items, scores, answered_by, True, latency, bucket))
            if span is not None:
                span.end(outcome="cache_hit", generation=answered_by)
            return fut

        deadline = None if deadline_ms is None else t0 + max(0.0, float(deadline_ms)) / 1e3
        req = Request(packed=packed, top_k=k, future=Future(), t_submit=t0,
                      deadline=deadline, span=span)
        try:
            self._batcher.submit(req)   # raises AdmissionRejected on overload
        except AdmissionRejected:
            if span is not None:
                span.end(outcome="rejected")
            raise
        # hit/miss is counted only for admitted requests, and on BOTH the
        # cache's and the gateway metrics' counters — the two published
        # hit-rates agree, and cache_hits + cache_misses == submitted
        self.cache.record(False)
        self.metrics.record_cache(False)
        return req.future

    def query(self, basket, top_k: int | None = None, timeout: float | None = 60.0,
              deadline_ms: float | None = None) -> Response:
        """Blocking convenience wrapper: ``submit(...).result(timeout)``."""
        return self.submit(basket, top_k, deadline_ms=deadline_ms).result(timeout)

    # ----------------------------------------------------------- hot-swap --
    def prepare_swap(self, rulebook: Rulebook, generation: int | None = None) -> "_Generation":
        """Phase 1 of the two-phase swap protocol (§12): device-place and
        (when ``warmup``) bucket-ladder-warm the incoming rulebook WITHOUT
        flipping the serving reference — both generations resident. Returns
        the prepared generation record for :meth:`commit_swap`. A failure
        here leaves serving untouched (the old generation keeps answering).

        ``generation`` pins the new generation id — the router uses this to
        keep ids aligned across replicas so a replica that missed a swap can
        re-sync straight to the coordinated target id.
        """
        if rulebook.num_items != self.num_items:
            raise ValueError(
                f"hot-swap rulebook has {rulebook.num_items} items, gateway "
                f"serves {self.num_items} — vocabulary must be stable across swaps"
            )
        gen_id = self._generation.generation + 1 if generation is None else int(generation)
        sp = None
        if self._tracer is not None and self._trace_root:
            sp = self._tracer.root("swap.prepare", force=True, generation=gen_id)
        try:
            gen = self._place(gen_id, rulebook)
            if self._warmup_enabled:
                self._warm(gen)          # double-buffer: warm before commit
        finally:
            if sp is not None:
                sp.end()
        return gen

    def commit_swap(self, prepared: "_Generation") -> int:
        """Phase 2: flip the serving reference to a prepared generation —
        one atomic store, same zero-drop/zero-mix contract as
        :meth:`hot_swap`."""
        sp = None
        if self._tracer is not None and self._trace_root:
            sp = self._tracer.root("swap.commit", force=True,
                                   generation=prepared.generation)
        with self._swap_lock:
            self._generation = prepared  # the atomic store
            self.metrics.record_swap()
            if sp is not None:
                sp.end()
            return prepared.generation

    def hot_swap(self, rulebook: Rulebook) -> int:
        """Atomically replace the serving rulebook; returns the new
        generation id. Prepare (place + warm, double-buffered) then commit —
        requests never stall on the incoming rulebook; requests already
        dispatched or queued resolve normally, and a response's
        ``generation`` says which rulebook answered.
        """
        with self._swap_lock:    # RLock: serializes concurrent hot_swaps so
            # two callers can never mint the same generation id
            return self.commit_swap(self.prepare_swap(rulebook))

    @property
    def generation(self) -> int:
        """Current serving generation id."""
        return self._generation.generation

    @property
    def queue_depth(self) -> int:
        """Requests currently queued in the batcher."""
        return self._batcher.depth

    @property
    def queue_capacity(self) -> int:
        """Admission-queue bound (brownout shedding's denominator, §14)."""
        return self._batcher.capacity

    def stats(self) -> dict:
        gen = self._generation
        out = self.metrics.snapshot()
        out["generation"] = gen.generation
        out["num_rules"] = gen.rulebook.num_rules
        out["queue_depth"] = self._batcher.depth
        out["max_wait_ms"] = self._batcher.current_max_wait_ms
        if self.wait_controller is not None:
            out["wait_controller"] = self.wait_controller.snapshot()
        out["cache"] = self.cache.snapshot()
        return out

    # ----------------------------------------------------------- internals --
    def _pack_one(self, basket) -> np.ndarray:
        """A 1-D uint32 array of exactly ``W`` words is the pre-packed form
        (how store rows arrive); every other sequence is an item-id list.
        Rows stay uint32 on the host and cross to the card as int32 views.
        The collision — uint32 *item ids* that happen to number exactly W —
        is unresolvable from the value alone, so submit id lists as plain
        Python ints / signed arrays, never uint32."""
        if (isinstance(basket, np.ndarray) and basket.ndim == 1
                and basket.dtype == np.uint32 and basket.shape[0] == self._words):
            return np.ascontiguousarray(basket)
        return pack_baskets([list(np.asarray(basket, dtype=np.int64))], self.num_items)[0]

    def _place(self, generation: int, rulebook: Rulebook) -> _Generation:
        """Commit a rulebook's columns to the gateway's device (unless they
        already live there) and wait until its copies have landed: a
        generation is published only once every one of its bytes is on
        the card, whichever thread placed it."""
        if rulebook.device != self.device:
            rulebook = place_rulebook(rulebook, self.device)
        if self.device.type == "cuda":
            # the copies ran on this thread's current stream; another
            # thread's dispatch must never read a half-copied rulebook
            torch.cuda.current_stream(self.device).synchronize()
        return _Generation(generation, rulebook)

    def _warm(self, gen: _Generation) -> None:
        """Run each bucket once for this generation off the serving path:
        the ladder endpoints, or with ``warmup="ladder"`` every
        power-of-two bucket.  The first launch builds the kernel library;
        each bucket leaves its buffers in the caching allocator."""
        if self._warmup_enabled == "ladder":
            ns = {1 << p for p in range(self.max_batch.bit_length())
                  if 1 << p <= self.max_batch} | {self.max_batch}
        else:
            ns = {1, self.max_batch}
        for n in sorted(ns):
            bucket = pow2_bucket(n, self.max_batch)
            self._match(np.zeros((bucket, self._words), np.uint32), gen, self.default_top_k)

    def _match(self, b: np.ndarray, gen: _Generation, top_k: int):
        """Pad-free core: one padded bucket of uint32 rows to the card (as
        int32 word views), through match + top-k, and back to host arrays.
        The copy back waits for the launches, so a caller's clock around
        this call spans the device work."""
        rb = gen.rulebook
        b_dev = _to_device(b.view(np.int32), rb.device)
        item_scores = self._step(b_dev, rb.ante_packed, rb.ante_len, rb.cons_packed, rb.scores)
        idx, vals = _topk_items(
            item_scores, b_dev,
            top_k=top_k, exclude_basket=self.exclude_basket, num_items=self.num_items,
        )
        return _to_host(idx, vals, b.shape[0])

    def _dispatch(self, group: list) -> None:
        """Batcher callback: one coalesced same-top_k group -> responses.

        The generation reference is read ONCE per dispatch — the whole batch
        is answered by a single rulebook, so responses can never mix
        generations within a batch."""
        gen = self._generation
        k = group[0].top_k
        t_drain = time.perf_counter()
        bucket = pow2_bucket(len(group), self.max_batch)
        b = np.zeros((bucket, self._words), np.uint32)
        for i, r in enumerate(group):
            b[i] = r.packed
        t_asm = time.perf_counter()
        idx, vals = self._match(b, gen, k)
        t_dev = time.perf_counter()
        tr = self._tracer
        if tr is not None:
            for r in group:
                if r.span is not None:
                    tr.add_span(r.span, "queue.wait", r.t_submit, t_drain)
                    tr.add_span(r.span, "batch.assemble", t_drain, t_asm,
                                batch=len(group), bucket=bucket)
                    tr.add_span(r.span, "device.dispatch", t_asm, t_dev,
                                bucket=bucket)
        self.metrics.record_batch(len(group), bucket)
        now = time.perf_counter()
        for i, r in enumerate(group):
            items, scores = idx[i], vals[i]
            self.cache.put(
                basket_key(r.packed, k, gen.generation),
                (items, scores, gen.generation, bucket),
            )
            latency = now - r.t_submit
            self.metrics.record_response(latency)
            if r.span is not None:
                # the per-request "where did the time go" breakdown the p99
                # bench row reads straight off the root span (§13)
                r.span.end(outcome="ok", generation=gen.generation, bucket=bucket,
                           queue_ms=(t_drain - r.t_submit) * 1e3,
                           batch_ms=(t_asm - t_drain) * 1e3,
                           device_ms=(t_dev - t_asm) * 1e3)
            r.future.set_result(Response(items, scores, gen.generation, False, latency, bucket))
