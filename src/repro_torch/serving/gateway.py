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

**On a mesh** (``mesh=``, ``launch.mesh``: one process a rank) every rank
builds the gateway, and each holds its block of every generation's rules
over ``rule_axis``.  Rank 0 is the leader: it alone admits requests and
runs the batcher, the cache, the metrics and the tracer.  The other ranks
follow: each consumes the leader's commands in one thread, in the order
they were sent.  A command is one broadcast over the mesh's host group (a
CPU tensor: a header and a padded bucket of packed words), and the leader
sends it, and runs the collectives that follow it, under one lock, so the
dispatch thread, a swap and a refresh never interleave collectives.  A
batch runs :func:`recommend.match_batch` on every rank: its basket block
over ``data_axes``, K2 on its rule block, the rule blocks summed in block
order, top-k, the blocks gathered over the data axes.  Its header names
the generation the leader read, and a follower answers it with that
generation's block.  A rank whose part of a batch raises still enters the
batch's two all-gathers, with its fault flag set
(``mapreduce.StepFaults``), so every rank stays in step and the leader
learns of every failure its answer reads (a top-k failing on a rank off the
leader's data group computed rows nobody reads, and the batch is answered
bit for bit).  The leader fails that batch's futures naming each failed
rank and its error (which a follower leaves in the default group's store),
and the next batch is answered as usual.  A swap is two commands: the rulebook's
host columns, each rank placing and warming its block, and an exchange of
every rank's outcome; only when every rank holds its block does the leader
commit, and the commit tells the followers to drop the older blocks.  A
refresh from :class:`~repro_torch.serving.refresh.RefreshController` mines
beside serving: one command starts the mine on every rank, which runs in a
thread of its own on the controller's mine mesh (groups of its own, so
the two threads of a rank never share a group; its shape is the
controller's, which may differ from the gateway's), and the gateway goes on
answering batches meanwhile.  Once every rank has mined and the ranks have
exchanged their outcomes (in the default group's store), the leader takes
the stream, names the generation, and each rank places its block of its
own rulebook; the commit follows at once, under the same lock, and a
follower's ``refresh_now`` returns once it has applied it.  A mesh
``Router``'s replicas are refreshed by a controller that drives its own
cycles: no MINE command comes, and a follower places the rulebook its
controller mined when the PLACE command comes.  While the
leader is idle it sends a heartbeat every quarter of the mesh's timeout, so
a follower waiting for a command never times out.  ``close()`` on the
leader resolves every admitted request, then stops the followers; on a
follower it waits for that stop and for a mine in flight.  A mesh of one
rank is the single-device gateway.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import traceback
from concurrent.futures import Future

import numpy as np
import torch

from repro_torch.core import itemsets as enc
from repro_torch.core.mapreduce import StepFaults
from repro_torch.data.store import open_store
from repro_torch.launch.mesh import mesh_device
from repro_torch.serving.batcher import AdmissionRejected, MicroBatcher, Request
from repro_torch.serving.cache import BasketCache, basket_key
from repro_torch.serving.metrics import GatewayMetrics
from repro_torch.serving.recommend import batch_gathers, make_match_step, match_batch, pack_baskets
from repro_torch.serving.rulebook import Rulebook, place_rulebook

# the leader's commands to the followers
BATCH, PREPARE, COMMIT, MINE, PLACE, HEARTBEAT, STOP = range(1, 8)
_HEADER = 6   # int64 fields: op, generation, bucket, top_k, rows, send time (us)


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


class _Commands:
    """The leader's one channel to the followers: a fixed CPU buffer (a
    header and the largest bucket of packed words) broadcast over the
    mesh's host group, whatever the ranks compute on (gloo cannot move CUDA
    tensors in every collective; the words go to the card after).
    ``lock`` is held by the leader through a command and the collectives
    that follow it (re-entrant: a refresh's place and commit go out under
    one hold)."""

    def __init__(self, mesh, max_bucket: int, words: int):
        self.mesh, self.words = mesh, words
        self.buf = torch.zeros(2 * _HEADER + max_bucket * words, dtype=torch.int32)
        self.head = self.buf[: 2 * _HEADER].view(torch.int64)
        self.lock = threading.RLock()
        self.sent = time.monotonic()

    def send(self, op: int, generation: int = 0, bucket: int = 0, top_k: int = 0, rows: int = 0,
             b: np.ndarray | None = None) -> None:
        self.head[:] = torch.tensor([op, generation, bucket, top_k, rows, int(time.time() * 1e6)])
        if b is not None:
            self.buf[2 * _HEADER : 2 * _HEADER + b.size] = torch.from_numpy(b.view(np.int32).reshape(-1))
        self.mesh.broadcast(self.buf)
        self.sent = time.monotonic()

    def recv(self):
        """The next command: ``(op, generation, bucket, top_k, rows,
        seconds since the leader sent it, words or None)``."""
        self.mesh.broadcast(self.buf)
        op, generation, bucket, top_k, rows, t_us = self.head.tolist()
        b = None
        if op == BATCH:
            b = self.buf[2 * _HEADER : 2 * _HEADER + bucket * self.words].numpy()
            b = b.reshape(bucket, self.words).view(np.uint32).copy()
        return op, generation, bucket, top_k, rows, max(0.0, time.time() - t_us / 1e6), b


class _Mine:
    """A follower's refresh mine: a thread of its own, beside the follow
    thread, running the controller's mine cycle on its mine mesh.  ``made``
    holds the rulebook before the ranks exchange their outcomes, so the
    follow thread finds it when the place command comes; ``error`` is what
    ended the thread, if anything (a follower's ``close()`` raises it)."""

    def __init__(self, gateway: "Gateway", rows: int):
        self.rows, self.t0 = rows, time.perf_counter()
        self.made: dict = {}
        self.placed: int | None = None   # the generation placed from it, until its commit
        self.error: BaseException | None = None
        self.thread = threading.Thread(target=self._run, args=(gateway,), name="refresh-mine", daemon=True)
        self.thread.start()

    def _run(self, gateway: "Gateway") -> None:
        controller = gateway._refresher
        try:
            if gateway.device.type == "cuda":   # the current card is a thread's own
                torch.cuda.set_device(gateway.device)
            errors = controller._mine_cycle(self.rows, self.made)
        except BaseException as e:  # noqa: BLE001 — close() re-raises it
            self.error = e
            errors = [f"rank {gateway._mesh.rank}: {traceback.format_exc()}"]
        if errors:   # the leader places nothing: the cycle ends here
            controller._followed(None, errors, self.made, self.rows, time.perf_counter() - self.t0)


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
        mesh=None,
        device="cuda",
        impl: str = "auto",
        top_k: int = 10,
        exclude_basket: bool = True,
        max_batch: int = 64,
        max_wait_ms: float = 1.0,
        p99_target_ms: float | None = None,
        queue_depth: int = 1024,
        cache_capacity: int = 4096,
        data_axes: tuple = ("data",),
        rule_axis: str = "model",
        warmup: bool | str = True,
        tracer=None,
        trace_root: bool = True,
    ):
        """``device``: where the rulebook lives and every match runs
        (``"cuda"`` by default; raises without CUDA unless ``"cpu"``).

        ``mesh``: serve as this rank of a ``launch.mesh.Mesh`` (on its
        device), baskets split over ``data_axes`` and rules over
        ``rule_axis`` (the module docstring).  Every rank constructs the
        gateway alike; rank 0 serves, the others follow until its
        ``close()``.  A mesh of one rank is the single-device gateway.

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
        cache-probe / queue-wait / batch-assembly / device-dispatch spans, and
        a batch that holds one gets a ``gateway.batch`` span of its cycle
        (:class:`_CycleTrace`, one card).
        ``trace_root=False`` (the router's replicas) makes the gateway only
        ever CONTINUE a trace handed in by its caller, never start one —
        sampling then happens once, at the router."""
        self.num_items = rulebook.num_items
        self.default_top_k = min(top_k, self.num_items)
        self.exclude_basket = exclude_basket
        self.max_batch = int(max_batch)
        self._words = enc.packed_words(self.num_items)
        self.device = mesh_device(device, mesh)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._warmup_enabled = warmup
        self._tracer = tracer
        self._trace_root = bool(trace_root)
        self._closed = False
        self._mesh = mesh if mesh is not None and mesh.size > 1 else None
        self._data_axes, self._rule_axis = tuple(data_axes), rule_axis

        # the SAME match step recommend() uses: gateway and batch engine
        # answer a basket bit for bit alike
        self._step = make_match_step(impl=impl)
        self._row_multiple = 1
        self._commands = None
        if self._mesh is not None:
            if rule_axis in self._data_axes or set(self._data_axes + (rule_axis,)) - set(mesh.axes):
                raise ValueError(f"data_axes {self._data_axes} and rule_axis {rule_axis!r} must be "
                                 f"distinct axes of the mesh {tuple(mesh.axes)}")
            build = (self.num_items, self.max_batch, self.default_top_k, exclude_basket,
                     self._data_axes, rule_axis, warmup, rulebook.num_rows)
            if any(other != build for other in mesh.all_gather_object(build)):
                raise ValueError("every rank must build the mesh gateway alike (items, max_batch, top_k, "
                                 "exclude_basket, axes, warmup, rulebook rows)")
            self._local_step = self._step   # a rank's own blocks: warming
            self._step = make_match_step(impl=impl, mesh=mesh, rule_axis=rule_axis, on_map=self._lap)
            self._row_multiple = mesh.shard(self._data_axes)[1]
            self._commands = _Commands(mesh, pow2_bucket(self.max_batch, self.max_batch, self._row_multiple),
                                       self._words)
            # seconds of the batches served, each stage summed (every rank)
            self.mesh_timing = dict(batches=0, broadcast_s=0.0, match_s=0.0, reduce_s=0.0, gather_s=0.0)
            self._laps: list = []
            self._batch_seq = 0   # the batches of the command stream, alike on every rank
        self.leader = self._mesh is None or mesh.rank == 0

        self.metrics = GatewayMetrics()
        self.cache = BasketCache(cache_capacity)
        self._swap_lock = threading.RLock()
        self._generation = self._place(0, rulebook)
        self.metrics.mark_generation_commit()   # freshness clock starts now
        if warmup:
            self._warm(self._generation)
        if not self.leader:
            # the generations a follower holds, by id: the serving one and
            # any prepared one (only the follow thread touches it; a
            # refresh's mine thread hands its rulebook over in its ``_Mine``)
            self._held = {0: self._generation}
            self._refresher = None
            self._attached = threading.Condition()
            self._mine: _Mine | None = None   # the refresh mine of the cycle in flight
            self._follow_error: BaseException | None = None
            self._follower = threading.Thread(target=self._follow, name="gateway-follower", daemon=True)
            self._follower.start()
            return
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
        if self._mesh is not None:
            self._quiet = threading.Event()
            self._beat = threading.Thread(target=self._heartbeat, name="gateway-heartbeat", daemon=True)
            self._beat.start()

    # ---------------------------------------------------------- lifecycle --
    def close(self) -> None:
        """Stop admitting; every already-admitted request still resolves.
        On a mesh the leader then stops the followers; a follower's
        ``close()`` waits for that stop and for its refresh mine in flight,
        and raises what ended its loop or its mine."""
        if not self.leader:
            self._follower.join()
            mine = self._mine
            if mine is not None:
                mine.thread.join()
            for error in (self._follow_error, mine and mine.error):
                if error is not None:
                    raise error
            return
        self._closed = True
        self._batcher.close()
        if self._mesh is not None and not self._quiet.is_set():
            with self._commands.lock:
                self._quiet.set()
                self._commands.send(STOP)
            self._beat.join()

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
        self._leader_only("submit")
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
        self._leader_only("prepare_swap")
        gen_id = self._generation.generation + 1 if generation is None else int(generation)
        sp = None
        if self._tracer is not None and self._trace_root:
            sp = self._tracer.root("swap.prepare", force=True, generation=gen_id)
        try:
            if self._mesh is not None:
                host = rulebook if rulebook.device is None else rulebook.to_host()
                with self._commands.lock:
                    self._commands.send(PREPARE, gen_id)
                    self._mesh.broadcast_object(host)
                    return self._prepared(*self._prepare_everywhere(gen_id, lambda: host))
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
        :meth:`hot_swap`.  On a mesh the followers commit with it (and drop
        every other block), in the command stream."""
        self._leader_only("commit_swap")
        sp = None
        if self._tracer is not None and self._trace_root:
            sp = self._tracer.root("swap.commit", force=True,
                                   generation=prepared.generation)
        with self._swap_lock:
            if self._mesh is None:
                self._generation = prepared  # the atomic store
            else:
                with self._commands.lock:   # batches read the generation under it
                    self._generation = prepared
                    self._commands.send(COMMIT, prepared.generation)
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
        self._leader_only("stats")
        gen = self._generation
        out = self.metrics.snapshot()
        out["generation"] = gen.generation
        out["num_rules"] = gen.rulebook.num_rules
        out["queue_depth"] = self._batcher.depth
        out["max_wait_ms"] = self._batcher.current_max_wait_ms
        if self.wait_controller is not None:
            out["wait_controller"] = self.wait_controller.snapshot()
        out["cache"] = self.cache.snapshot()
        if self._mesh is not None:
            out["mesh_timing"] = dict(self.mesh_timing)
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

    def _leader_only(self, what: str) -> None:
        if not self.leader:
            raise RuntimeError(f"{what}: rank {self._mesh.rank} follows the mesh gateway's leader, "
                               "rank 0, which alone admits requests and swaps")

    def _place(self, generation: int, rulebook: Rulebook) -> _Generation:
        """Commit a rulebook's columns to the gateway's device (unless they
        already live there) and wait until its copies have landed: a
        generation is published only once every one of its bytes is on
        the card, whichever thread placed it.  On a mesh this rank keeps
        its block of the rules over the rule axis."""
        if self._mesh is not None:
            if rulebook.shard is None:
                rulebook = place_rulebook(rulebook.to_host() if rulebook.device is not None else rulebook,
                                          self.device, mesh=self._mesh, rule_axis=self._rule_axis)
            elif (rulebook.shard.mesh, rulebook.shard.rule_axis) != (self._mesh, self._rule_axis):
                raise ValueError("the rulebook was placed for another mesh or rule axis than the gateway's")
        elif rulebook.device != self.device:
            rulebook = place_rulebook(rulebook, self.device)
        if self.device.type == "cuda":
            # the copies ran on this thread's current stream; another
            # thread's dispatch must never read a half-copied rulebook
            torch.cuda.current_stream(self.device).synchronize()
        return _Generation(generation, rulebook)

    def ladder(self) -> list:
        """The buckets a generation is warmed at, as dispatch pads them:
        the ladder endpoints, or with ``warmup="ladder"`` every
        power-of-two bucket (each a multiple of the data shards)."""
        if self._warmup_enabled == "ladder":
            ns = {1 << p for p in range(self.max_batch.bit_length())
                  if 1 << p <= self.max_batch} | {self.max_batch}
        else:
            ns = {1, self.max_batch}
        return sorted({pow2_bucket(n, self.max_batch, self._row_multiple) for n in ns})

    def _warm(self, gen: _Generation) -> None:
        """Run each bucket of :meth:`ladder` once for this generation off
        the serving path.  The first launch builds the kernel library; each
        bucket leaves its buffers in the caching allocator.  On a mesh each
        rank warms its own blocks (its share of the bucket against its rule
        block), with no collective."""
        for bucket in self.ladder():
            if self._mesh is None:
                self._match(np.zeros((bucket, self._words), np.uint32), gen, self.default_top_k)
            else:
                match_batch(self._local_step, np.zeros((bucket // self._row_multiple, self._words), np.int32),
                            gen.rulebook, top_k=self.default_top_k, exclude_basket=self.exclude_basket)

    def _lap(self, _stage=None) -> None:
        """A mesh batch's stage has ended: its time, once the device is done."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._laps.append(time.perf_counter())

    def _match(self, b: np.ndarray, gen: _Generation, top_k: int, faults: StepFaults | None = None,
               lap=None):
        """Pad-free core: one padded bucket of uint32 rows to the card (as
        int32 word views), through match + top-k, and back to host arrays
        (:func:`recommend.match_batch`, which calls ``lap`` at each stage's
        end on one card).  The copy back waits for the launches, so a
        caller's clock around this call spans the device work.  On a mesh
        every rank runs it on the same bucket, ``faults`` riding the batch's
        all-gathers."""
        if self._mesh is None:
            return match_batch(self._step, b.view(np.int32), gen.rulebook, top_k=top_k,
                               exclude_basket=self.exclude_basket, lap=lap)
        self._laps = [time.perf_counter()]
        out = match_batch(self._step, b.view(np.int32), gen.rulebook, top_k=top_k,
                          exclude_basket=self.exclude_basket, mesh=self._mesh, data_axes=self._data_axes,
                          lap=self._lap, faults=faults)
        t = self._laps
        timing = self.mesh_timing
        timing["batches"] += 1
        for key, (a, z) in zip(("match_s", "reduce_s", "gather_s"), zip(t, t[1:])):
            timing[key] += z - a
        return out

    def _mesh_batch(self, b: np.ndarray, generation: int, top_k: int):
        """Every rank, one batch of the command stream: :meth:`_match` with
        its failure carried as data.  A rank whose part raises (before,
        between or after the batch's all-gathers) enters the ones it has
        not, flag set, and a follower leaves its error in the store under
        the batch's number.  Returns the leader's ``(idx, vals)``, or raises
        on the leader, naming every failed rank and its error; on a
        follower returns None.  An all-gather that itself fails (a lost
        peer) raises on every rank: that stays fatal."""
        mesh = self._mesh
        self._batch_seq += 1
        faults = StepFaults(mesh, batch_gathers(mesh, b.shape[0], self._words, top_k, self._data_axes,
                                                 self._rule_axis))
        out = None
        try:
            # the leader's serving generation is ``generation``: both are read under the command lock
            gen = self._generation if self.leader else self._held[generation]
            out = self._match(b, gen, top_k, faults)
        except Exception:  # noqa: BLE001 — carried to every rank below
            if faults.lost:
                raise
            faults.fail()
            error = traceback.format_exc()
            if not self.leader and faults.entered < len(faults.plan):   # else no rank learns of it
                mesh.store.set(f"batch/{self._batch_seq}/{mesh.rank}", error)
            faults.drain()
        if not self.leader or not faults.ranks:
            return out
        errors = []
        for r in faults.ranks:
            if r == mesh.rank:
                errors.append(f"rank {r}: {error}")
                continue
            key = f"batch/{self._batch_seq}/{r}"
            errors.append(f"rank {r}: {mesh.store.get(key).decode()}")
            mesh.store.delete_key(key)
        raise RuntimeError(f"the batch failed on {len(errors)} rank(s) of the mesh:\n" + "\n".join(errors))

    # ---------------------------------------------------------------- mesh --
    def _heartbeat(self) -> None:
        """Leader: a command at least every quarter of the mesh's timeout."""
        every = self._mesh.timeout_s / 4
        while not self._quiet.wait(every / 4):
            with self._commands.lock:
                if not self._quiet.is_set() and time.monotonic() - self._commands.sent >= every:
                    self._commands.send(HEARTBEAT)

    def _prepare_everywhere(self, generation: int, make_rulebook) -> tuple:
        """Every rank: place and warm its block of ``make_rulebook()``, then
        exchange every rank's outcome (the barrier before a commit).
        Returns ``(generation record or None, the ranks' errors)``: a rank
        that failed fails the swap on every rank, and the serving
        generation stays.  Every rank reaches the exchange, whatever
        failed before it, or the others would wait there."""
        try:
            gen = self._place(generation, make_rulebook())
            if self._warmup_enabled:
                self._warm(gen)
            error = None
        except Exception:  # noqa: BLE001 — reported to every rank below
            gen, error = None, f"rank {self._mesh.rank}: {traceback.format_exc()}"
        errors = [e for e in self._mesh.all_gather_object(error) if e is not None]
        return (None if errors else gen), errors

    def _prepared(self, gen, errors) -> _Generation:
        if errors:
            raise RuntimeError(f"generation {self._generation.generation} keeps serving: preparing the next "
                               f"failed on {len(errors)} rank(s):\n" + "\n".join(errors))
        return gen

    def _refresh(self, controller) -> tuple:
        """Leader: one refresh cycle of a mesh ``RefreshController`` on
        every rank.  The mine runs beside serving, outside the locks; then
        the place and the commit go through the command stream, with the
        generation id taken under the swap lock (an operator's swap may
        have landed during the mine).  Returns ``(generation, what the
        cycle made, the rows it covers)``."""
        with self._commands.lock:
            self._open_stream()
            rows = open_store(controller.store_path).num_transactions
            self._commands.send(MINE, rows=rows)
        made = {}
        errors = controller._mine_cycle(rows, made)
        if errors:
            raise RuntimeError(f"generation {self.generation} keeps serving: the refresh's mine failed on "
                               f"{len(errors)} rank(s):\n" + "\n".join(errors))
        with self._swap_lock, self._commands.lock:   # the commit follows the place at once
            gen_id = self._generation.generation + 1
            self.commit_swap(self._place_mined(made["rulebook"], gen_id))
        return gen_id, made, rows

    def _place_mined(self, rulebook: Rulebook, generation: int) -> _Generation:
        """Leader, a mesh refresh's place: every rank places and warms its
        block of the rulebook it mined itself (the PLACE command), and the
        ranks exchange outcomes.  Returns the generation record for
        :meth:`commit_swap`, or raises with the ranks' errors (the serving
        generation stays)."""
        with self._commands.lock:
            self._open_stream()
            self._commands.send(PLACE, generation)
            return self._prepared(*self._prepare_everywhere(generation, lambda: rulebook))

    def _open_stream(self) -> None:
        """Leader, under the command lock: raise once ``close()`` has
        stopped the followers."""
        if self._quiet.is_set():
            raise RuntimeError(f"the gateway is closed; generation {self.generation} keeps serving")

    def _attach(self, controller) -> None:
        """A mesh ``RefreshController`` of this gateway: a follower runs its
        cycles when the leader's commands say so."""
        if not self.leader:
            with self._attached:
                self._refresher = controller
                self._attached.notify_all()

    def _await_generation(self, generation: int) -> None:
        """Follower: return once the leader's commit of ``generation`` (or
        of a later one) is applied on this rank."""
        while self._generation.generation < generation:
            if not self._follower.is_alive():
                raise RuntimeError(f"the gateway's follow loop ended before generation {generation} served "
                                   f"here") from self._follow_error
            time.sleep(0.002)

    def _follow(self) -> None:
        """Follower: consume the leader's commands, in order, until STOP."""
        try:
            if self.device.type == "cuda":   # the current card is a thread's own
                torch.cuda.set_device(self.device)
            while True:
                op, generation, bucket, top_k, rows, sent_s, b = self._commands.recv()
                if op == BATCH:
                    self.mesh_timing["broadcast_s"] += sent_s
                    self._mesh_batch(b, generation, top_k)
                elif op == PREPARE:
                    host = self._mesh.broadcast_object()
                    gen, _ = self._prepare_everywhere(generation, lambda: host)
                    if gen is not None:
                        self._held[generation] = gen
                elif op == COMMIT:
                    self._generation = self._held[generation]
                    self._held = {generation: self._generation}
                    mine = self._mine
                    if mine is not None and mine.placed == generation:   # the refresh's commit
                        mine.placed = None
                        self._refresher._followed(generation, [], mine.made, mine.rows,
                                                  time.perf_counter() - mine.t0)
                elif op == MINE:
                    with self._attached:
                        if not self._attached.wait_for(lambda: self._refresher is not None,
                                                       timeout=self._mesh.timeout_s):
                            raise RuntimeError("the leader refreshes, but no RefreshController was "
                                               "built on this rank")
                    if self._mine is not None:   # the last cycle's, past the exchange the
                        self._mine.thread.join()  # leader passed before this command
                    self._mine = _Mine(self, rows)
                elif op == PLACE:
                    # what this rank mined: in this gateway's refresh mine, or in the
                    # controller, where it drives the cycles itself (a router's replica)
                    mine = self._mine
                    made = mine.made if mine is not None else getattr(self._refresher, "mined", {})
                    if "rulebook" not in made:
                        raise RuntimeError("the leader places a refresh this rank has not mined")
                    gen, errors = self._prepare_everywhere(generation, lambda: made["rulebook"])
                    if mine is None:   # the controller learns the cycle's end from the leader
                        if not errors:
                            self._held[generation] = gen
                    elif errors:   # the leader commits nothing: the cycle ends here
                        self._refresher._followed(generation, errors, mine.made, mine.rows,
                                                  time.perf_counter() - mine.t0)
                    else:        # it ends at the commit that follows
                        self._held[generation], mine.placed = gen, generation
                elif op == STOP:
                    return
        except BaseException as e:  # noqa: BLE001 — close() re-raises it
            self._follow_error = e

    def _dispatch(self, group: list) -> None:
        """Batcher callback: one coalesced same-top_k group -> responses.

        The generation reference is read ONCE per dispatch — the whole batch
        is answered by a single rulebook, so responses can never mix
        generations within a batch.  On a mesh it is read under the command
        lock, and the batch's command names it to the followers.  A traced
        batch's cycle starts at the batcher's ``collect_start``."""
        t_drain = time.perf_counter()
        tr = self._tracer
        if tr is None or self._mesh is not None:
            return self._answer(group, t_drain, None)
        first = next((r.span for r in group if r.span is not None), None)
        if first is None:
            return self._answer(group, t_drain, None)
        cycle = _CycleTrace(tr, first, self._batcher.collect_start, t_drain, self.device)
        try:
            self._answer(group, t_drain, cycle)
        except BaseException:
            cycle.end(outcome="error")   # closes the open stage's profiler range on this thread
            raise

    def _answer(self, group: list, t_drain: float, cycle) -> None:
        k = group[0].top_k
        tr = self._tracer
        bucket = pow2_bucket(len(group), self.max_batch, self._row_multiple)
        b = np.zeros((bucket, self._words), np.uint32)
        for i, r in enumerate(group):
            b[i] = r.packed
        t_asm = time.perf_counter()
        if self._mesh is None:
            gen = self._generation
            if cycle is None:
                idx, vals = self._match(b, gen, k)
            else:
                cycle.lap("assemble")
                idx, vals = self._match(b, gen, k, lap=cycle.lap)
        else:
            with self._commands.lock:
                gen = self._generation
                t_send = time.perf_counter()
                self._commands.send(BATCH, gen.generation, bucket, k, len(group), b)
                self.mesh_timing["broadcast_s"] += time.perf_counter() - t_send
                idx, vals = self._mesh_batch(b, gen.generation, k)
        t_dev = time.perf_counter()
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
                r.span.end(outcome="ok", generation=gen.generation, bucket=bucket)
            r.future.set_result(Response(items, scores, gen.generation, False, latency, bucket))
        if cycle is not None:
            cycle.end(batch=len(group), bucket=bucket)


class _CycleTrace:
    """One traced batch's cycle on the dispatch thread: a ``gateway.batch``
    span from the batcher's first take (``t_first``) to the last answer
    set, under the first sampled request's span (which ends at its own
    answer, inside the demux).  Its stages tile it: ``cycle.collect``
    (back-dated), then ``cycle.assemble``, ``cycle.h2d``, ``cycle.match``
    (the K2 enqueue), ``cycle.topk``, ``cycle.d2h`` (the wait and the copy)
    and ``cycle.demux``, each live from the end of the stage before
    (:meth:`lap`, ``match_batch``'s stage hook).  ``gpu.match`` and
    ``gpu.topk`` are those launches' device time by CUDA events, read after
    the copy back has waited and anchored at their enqueue; on the CPU, the
    host time of the calls."""

    NEXT = {"assemble": "h2d", "h2d": "match", "match": "topk", "topk": "d2h", "d2h": "demux"}

    def __init__(self, tracer, parent, t_first: float, t_drain: float, device):
        self.tracer = tracer
        self.batch = tracer.child(parent, "gateway.batch")
        self.batch.t0 = t_first
        tracer.add_span(self.batch, "cycle.collect", t_first, t_drain)
        self.stage = tracer.live(self.batch, "cycle.assemble")
        self.stage.t0 = t_drain
        self.stream = torch.cuda.current_stream(device) if device.type == "cuda" else None
        self.marks: dict = {}

    def lap(self, stage: str) -> None:
        t = time.perf_counter()
        ev = None
        if self.stream is not None and stage in ("h2d", "match", "topk"):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(self.stream)
        self.marks[stage] = (t, ev)
        done = self.stage
        done.end()
        self.stage = self.tracer.live(self.batch, "cycle." + self.NEXT[stage])
        self.stage.t0 = done.t1   # the stages tile the cycle: the tracer's own work goes to the next
        if stage == "d2h":
            for name, a, z in (("gpu.match", "h2d", "match"), ("gpu.topk", "match", "topk")):
                (t0, e0), (t1, e1) = self.marks[a], self.marks[z]
                dur = e0.elapsed_time(e1) / 1e3 if e0 is not None else t1 - t0
                self.tracer.add_span(self.batch, name, t0, t0 + dur)

    def end(self, **attrs) -> None:
        self.stage.end()
        self.batch.end(**attrs)
        self.batch.t1 = self.stage.t1   # with its last stage, not after that stage's wait for the tracer's lock
