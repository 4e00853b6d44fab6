"""Replicated serving tier: failure-aware router over N gateway replicas (§12).

The single :class:`~repro_torch.serving.gateway.Gateway` already survives a crashed
dispatch worker (supervisor restart, §11) — but it is still ONE queue, ONE
worker, ONE cache. This module replicates the whole gateway N times and puts
a :class:`Router` in front, the serving-side analogue of the paper's
JobTracker over N TaskTrackers:

* **Consistent basket hashing.** Every basket's packed bitset hashes onto a
  virtual-node ring (:class:`HashRing`); the owning replica answers it.
  Repeat baskets keep landing on the same replica, so each replica's
  exact-basket LRU stays effective — N replicas partition the working set
  instead of duplicating it (the N-replica cache argument, DESIGN.md §12).

* **Health + failover.** Replicas move healthy → suspect → dead, driven by
  dispatch-worker liveness and consecutive attempt failures; a failed
  attempt (``WorkerCrashed``, an unresponsive replica's attempt timeout) is
  re-submitted to the next candidate on the ring with bounded retries and
  exponential backoff — the SAME :class:`FaultConfig` / ``retry_delay``
  policy the SON partition executor uses for map re-execution. Re-running a
  basket query is safe for the same reason a map task is: matching is
  read-only, first completion wins.

* **Deadlines.** ``submit(..., deadline_ms=...)`` bounds the REQUEST across
  all retries: the per-replica batcher drops past-deadline queued requests
  at dispatch, and the router's watchdog fails the outer future with
  :class:`DeadlineExceeded` even when the holding replica never answers.

* **Load shedding.** When every candidate replica is dead or its admission
  queue is full, the router rejects with a typed
  :class:`AdmissionRejected` — overload and total failure degrade loudly,
  never as a hang.

* **Coordinated two-phase hot-swap.** :meth:`Router.hot_swap` runs phase 1
  (``prepare_swap``: place + warm, double-buffered) on EVERY live replica,
  then phase 2 flips all serving references to the coordinated generation
  id. A replica that fails prepare is marked suspect and keeps answering
  its stale generation — tracked by the ``max_generation_lag`` metric —
  until the monitor re-syncs it to the target generation.

Fault injection for tests/benchmarks rides the batcher's in-worker crash
hook: :class:`RouterFaultInjection` can kill a replica's worker mid-batch,
delay its dispatches, or fail its swap prepares.

**On a mesh** (``mesh=``, ``launch.mesh``: one process a rank) every rank
builds the router alike, and each replica is a mesh
:class:`~repro_torch.serving.gateway.Gateway` on process groups of its own:
the first on ``mesh``, each other on a twin of it (``Mesh.twin()``), so no
two replicas' command streams ever share a group.  Building a twin is a
collective call, so every rank builds them all, in one order, before the
first replica starts its follow thread.  Rank 0 leads: its router is the
one above (the ring, failover, supervised restarts, the coordinated swap,
each replica's prepare and commit going through that replica's own command
stream).  On every other rank the router holds its replicas' follower
gateways and nothing else; ``submit``, ``stats`` and swaps raise there, and
``close()`` waits for the leader's to stop each replica's followers.  A
killed dispatch worker dies before its batch's command is sent, so no
follower is left in a collective.
"""

from __future__ import annotations

import bisect
import dataclasses
import functools
import hashlib
import heapq
import itertools
import threading
import time
from concurrent.futures import Future

from repro_torch.distributed.fault_tolerance import FaultConfig, InjectedFailure, retry_delay
from repro_torch.distributed.supervisor import ReplicaSetSupervisor
from repro_torch.obs.registry import Histogram
from repro_torch.serving.batcher import AdmissionRejected, DeadlineExceeded, WorkerCrashed
from repro_torch.serving.gateway import Gateway
from repro_torch.serving.metrics import RouterMetrics
from repro_torch.serving.rulebook import Rulebook

HEALTHY = "healthy"
SUSPECT = "suspect"
DEAD = "dead"


def _stable_hash(data: bytes) -> int:
    """64-bit blake2b — stable across processes/runs (unlike ``hash()``),
    so ring placement and tests are reproducible."""
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(), "big")


class HashRing:
    """Consistent-hash ring with virtual nodes.

    ``preference(key)`` returns ALL replica ids in ring order starting at the
    key's owner — the router's failover order, so a dead owner's baskets
    spill deterministically onto the same successor (that successor's cache
    absorbs exactly one shard, not a random shuffle)."""

    def __init__(self, num_replicas: int, vnodes: int = 64):
        if num_replicas < 1:
            raise ValueError("num_replicas must be >= 1")
        self.num_replicas = int(num_replicas)
        self.vnodes = int(vnodes)
        points = []
        for rid in range(num_replicas):
            for v in range(vnodes):
                points.append((_stable_hash(f"replica-{rid}/vnode-{v}".encode()), rid))
        points.sort()
        self._points = points
        self._hashes = [h for h, _ in points]

    def preference(self, key: bytes) -> list[int]:
        """Replica ids in ring-walk order from the key's owner (owner first,
        every replica exactly once)."""
        h = _stable_hash(key)
        start = bisect.bisect_right(self._hashes, h) % len(self._points)
        seen: set[int] = set()
        order: list[int] = []
        for j in range(len(self._points)):
            rid = self._points[(start + j) % len(self._points)][1]
            if rid not in seen:
                seen.add(rid)
                order.append(rid)
                if len(order) == self.num_replicas:
                    break
        return order

    def owner(self, key: bytes) -> int:
        return self.preference(key)[0]


class RouterFaultInjection:
    """Chaos hooks for the replica set (tests, benchmarks, serve CLI).

    ``kill_replica`` arms a one-shot in-worker ``SystemExit`` on the
    replica's NEXT dispatch — the worker dies with the batch in flight,
    exercising the real stranding → supervisor-restart → failover path.
    ``delay_replica`` makes every dispatch sleep first (an unresponsive
    replica: the router's attempt watchdog fires, the slow answer is
    discarded). ``fail_swap_on`` makes two-phase prepare fail (sticky until
    cleared, or one-shot) — the stale-generation degradation path."""

    def __init__(self):
        self._lock = threading.Lock()
        self._kill_once: set[int] = set()
        self._delay_s: dict[int, float] = {}
        self._swap_fail: set[int] = set()
        self._swap_fail_once: set[int] = set()
        self.kills_fired = 0

    def kill_replica(self, rid: int) -> None:
        with self._lock:
            self._kill_once.add(int(rid))

    def delay_replica(self, rid: int, seconds: float) -> None:
        with self._lock:
            if seconds > 0:
                self._delay_s[int(rid)] = float(seconds)
            else:
                self._delay_s.pop(int(rid), None)

    def fail_swap_on(self, rid: int, once: bool = False) -> None:
        with self._lock:
            (self._swap_fail_once if once else self._swap_fail).add(int(rid))

    def clear_swap_failures(self, rid: int | None = None) -> None:
        with self._lock:
            if rid is None:
                self._swap_fail.clear()
                self._swap_fail_once.clear()
            else:
                self._swap_fail.discard(int(rid))
                self._swap_fail_once.discard(int(rid))

    # ---- consulted by the router / installed into replica batchers --------
    def _on_dispatch(self, rid: int, batch=None) -> None:
        """Runs IN the replica's dispatch worker, batch already in flight."""
        with self._lock:
            kill = rid in self._kill_once
            if kill:
                self._kill_once.discard(rid)
                self.kills_fired += 1
            delay = self._delay_s.get(rid, 0.0)
        if delay > 0:
            time.sleep(delay)
        if kill:
            raise SystemExit(f"injected kill: replica {rid} dispatch worker")

    def _should_fail_swap(self, rid: int) -> bool:
        with self._lock:
            if rid in self._swap_fail_once:
                self._swap_fail_once.discard(rid)
                return True
            return rid in self._swap_fail


class Replica:
    """One gateway plus its router-side health record."""

    __slots__ = ("rid", "gateway", "state", "consecutive_failures", "last_failure_t")

    def __init__(self, rid: int, gateway: Gateway):
        self.rid = rid
        self.gateway = gateway
        self.state = HEALTHY
        self.consecutive_failures = 0
        self.last_failure_t = 0.0

    @property
    def available(self) -> bool:
        """Dispatchable: not declared dead and still admitting. A replica
        whose worker just died but is being supervised stays available —
        queued requests survive the restart."""
        return self.state != DEAD and not self.gateway._batcher.closed

    def note_failure(self, suspect_after: int) -> None:
        self.consecutive_failures += 1
        self.last_failure_t = time.perf_counter()
        if self.state == HEALTHY and self.consecutive_failures >= suspect_after:
            self.state = SUSPECT

    def note_success(self) -> None:
        # successes end the failure streak but do NOT promote the replica:
        # re-healthy is the monitor's call, after ``healthy_after_s`` of
        # quiet (a suspect replica that answers one request hasn't proven
        # anything yet, and an instant flip would make the health dip
        # invisible to anything sampling the healthy-replica gauge)
        self.consecutive_failures = 0

    def mark_dead(self) -> bool:
        """Returns True on the transition (for once-only death accounting)."""
        if self.state != DEAD:
            self.state = DEAD
            return True
        return False


class _RouterTask:
    """One routed request across all its attempts."""

    __slots__ = ("outer", "packed", "top_k", "deadline", "t_submit",
                 "attempts", "cursor", "pref", "lock",
                 "span", "att_span", "t_parked")

    def __init__(self, outer, packed, top_k, deadline, t_submit, pref):
        self.outer = outer
        self.packed = packed
        self.top_k = top_k
        self.deadline = deadline
        self.t_submit = t_submit
        self.attempts = 0        # dispatches actually made (or burnt retries)
        self.cursor = 0          # rotation into the ring preference list
        self.pref = pref
        self.lock = threading.Lock()   # guards the outer future's resolution
        self.span = None         # sampled root span for the whole request (§13)
        self.att_span = None     # span of the single in-flight attempt
        self.t_parked = 0.0      # when the task was parked for retry backoff


class Router:
    """Failure-aware front over N independent :class:`Gateway` replicas.

    Same submit/query surface as a single gateway — drop-in for the load
    harness — plus coordinated :meth:`hot_swap`, replica-set :meth:`stats`,
    and a :attr:`fault_injection` chaos seam. Every admitted request reaches
    exactly one terminal outcome: a Response (bit-identical to
    ``recommend()`` against the answering generation), or a typed
    :class:`DeadlineExceeded` / :class:`AdmissionRejected` /
    :class:`WorkerCrashed` — never a hang.
    """

    def __init__(
        self,
        rulebook: Rulebook,
        num_replicas: int = 2,
        *,
        mesh=None,
        device="cuda",
        fault: FaultConfig = FaultConfig(),
        attempt_timeout_s: float = 1.0,
        suspect_after: int = 2,
        healthy_after_s: float = 0.2,
        vnodes: int = 64,
        supervise: bool = True,
        monitor_interval_s: float = 0.02,
        max_restarts: int = 5,
        restart_window_s: float = 10.0,
        tracer=None,
        **gateway_kwargs,
    ):
        """``mesh``: every replica serves on this mesh (the module
        docstring); ``gateway_kwargs`` (``data_axes``, ``rule_axis``,
        ``max_batch``, ...) reach every replica's :class:`Gateway`."""
        if num_replicas < 1:
            raise ValueError("num_replicas must be >= 1")
        self._tracer = tracer
        self._closed = False
        on_mesh = mesh is not None and mesh.size > 1
        self._mesh = mesh if on_mesh else None
        self.leader = not on_mesh or mesh.rank == 0
        # every twin before the first replica, whose followers start
        # consuming commands on their groups at once
        meshes = [mesh] + [mesh.twin() if on_mesh else mesh for _ in range(num_replicas - 1)]

        # N fully independent gateways: own batcher, own cache, own device
        # placement — N placed rulebooks on the one card. The kernel
        # library is built once and shared underneath.
        # replicas share the router's tracer but never START a trace
        # themselves (trace_root=False): one request = one trace, sampled
        # once at the router, continued through whichever replicas serve it
        self._replicas = [
            Replica(rid, Gateway(rulebook, mesh=m, device=device, tracer=tracer,
                                 trace_root=False, **gateway_kwargs))
            for rid, m in enumerate(meshes)
        ]
        if not self.leader:
            return
        self.fault = fault
        self._attempt_timeout = float(attempt_timeout_s)
        self._suspect_after = int(suspect_after)
        self._healthy_after = float(healthy_after_s)
        self._monitor_interval = float(monitor_interval_s)
        self.metrics = RouterMetrics()
        self.fault_injection = RouterFaultInjection()
        self._ring = HashRing(num_replicas, vnodes)
        # alert-driven brownout (§14): 0 = normal, 1 = warn (shed above 50%
        # aggregate queue fill), 2 = page (shed above 25%) — a burning
        # availability SLO tightens admission instead of letting queues fill
        self._brownout_level = 0
        for rep in self._replicas:
            rep.gateway._batcher._crash_hook = functools.partial(
                self.fault_injection._on_dispatch, rep.rid
            )
        self.num_items = self._replicas[0].gateway.num_items
        self.default_top_k = self._replicas[0].gateway.default_top_k

        self._target_generation = 0
        self._target_rulebook = rulebook
        self._swap_lock = threading.Lock()

        # retry heap + in-flight attempt watchdog, drained by the driver
        self._lock = threading.Lock()
        self._heap: list = []            # (due_time, seq, task)
        self._inflight: dict = {}        # token -> (task, rid, timeout_at)
        self._seq = itertools.count()
        self._token = itertools.count()

        self._stop_driver = threading.Event()
        self._driver = threading.Thread(
            target=self._drive, name="router-driver", daemon=True
        )
        self._driver.start()
        self._stop_monitor = threading.Event()
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="router-monitor", daemon=True
        )
        self._monitor.start()
        self.supervisor = None
        if supervise:
            self.supervisor = ReplicaSetSupervisor(
                [rep.gateway for rep in self._replicas],
                max_restarts=max_restarts,
                restart_window_s=restart_window_s,
                on_gave_up=self._on_replica_gave_up,
            )

    def _leader_only(self, what: str) -> None:
        if not self.leader:
            raise RuntimeError(f"{what}: rank {self._mesh.rank} holds the mesh router's follower replicas; "
                               "rank 0 alone admits requests and swaps")

    # ----------------------------------------------------------- requests --
    def submit(self, basket, top_k: int | None = None, deadline_ms: float | None = None):
        """Admit one basket query; returns a Future resolving to a gateway
        :class:`~repro_torch.serving.gateway.Response` whose ``latency_s`` is the
        ROUTER-level submit→resolution time (failover + backoff included).

        Raises :class:`AdmissionRejected` when the router is closed or no
        candidate replica can take the request (all dead / all saturated) —
        the load-shedding path."""
        self._leader_only("submit")
        if self._closed:
            self.metrics.record_shed()
            raise AdmissionRejected("router closed")
        level = self._brownout_level
        if level:
            # brownout: admit only while aggregate queue fill stays under the
            # level's budget — overload sheds EARLY (typed reject in ~µs)
            # instead of queueing work the burning tier cannot absorb
            depth = cap = 0
            for rep in self._replicas:
                if rep.available:
                    depth += rep.gateway.queue_depth
                    cap += rep.gateway.queue_capacity
            budget = 0.5 if level == 1 else 0.25
            if cap == 0 or depth >= cap * budget:
                self.metrics.record_brownout_shed()
                raise AdmissionRejected(
                    f"brownout (availability alert, level {level}): "
                    f"aggregate queue {depth}/{cap} over the {budget:.0%} budget"
                )
        t0 = time.perf_counter()
        packed = self._replicas[0].gateway._pack_one(basket)
        k = min(self.default_top_k if top_k is None else int(top_k), self.num_items)
        deadline = None if deadline_ms is None else t0 + max(0.0, float(deadline_ms)) / 1e3
        task = _RouterTask(Future(), packed, k, deadline, t0,
                           self._ring.preference(packed.tobytes()))
        if self._tracer is not None:
            task.span = self._tracer.root("router.request", top_k=k)
            if task.span is not None:
                task.span.t0 = t0   # backdate to submit entry: admit nests
                # admission: pack + ring lookup, before the first attempt
                self._tracer.add_span(task.span, "router.admit", t0,
                                      time.perf_counter(),
                                      owner=task.pref[0])
        if not self._try_dispatch(task):
            self.metrics.record_shed()
            if task.span is not None:
                task.span.end(outcome="shed")
            raise AdmissionRejected("all replicas dead or saturated")
        self.metrics.record_routed()
        return task.outer

    def query(self, basket, top_k: int | None = None, timeout: float | None = 60.0,
              deadline_ms: float | None = None):
        """Blocking convenience wrapper: ``submit(...).result(timeout)``."""
        return self.submit(basket, top_k, deadline_ms=deadline_ms).result(timeout)

    # ----------------------------------------------------------- hot-swap --
    def hot_swap(self, rulebook: Rulebook) -> int:
        """Coordinated two-phase swap across the replica set.

        Phase 1 prepares (place + warm) on every live replica; phase 2 flips
        all their serving references to one coordinated generation id. A
        replica that fails prepare — or is down — is marked suspect, keeps
        answering its stale generation (``max_generation_lag`` tracks the
        gap), and is re-synced by the monitor once it can take the swap.
        Raises if NO replica completed prepare (nothing was committed)."""
        self._leader_only("hot_swap")
        return self._swap(rulebook, lambda gw, target: gw.prepare_swap(rulebook, generation=target))[0]

    def _swap_mined(self, rulebook: Rulebook) -> tuple:
        """Leader, a mesh ``RefreshController``'s cycle: :meth:`hot_swap`,
        in which each mesh replica's ranks place their blocks of the
        rulebook each rank mined itself (``Gateway._place_mined``) instead
        of the leader's host columns.  Returns ``(generation, the ids of
        the replicas committed)``."""
        return self._swap(rulebook, lambda gw, target: gw._place_mined(rulebook, target))

    def _swap(self, rulebook: Rulebook, prepare) -> tuple:
        """The coordinated swap, ``prepare(gateway, generation)`` being its
        phase 1 on one replica.  Returns ``(generation, the ids of the
        replicas committed)``."""
        with self._swap_lock:
            target = self._target_generation + 1
            swap_sp = None
            if self._tracer is not None:
                swap_sp = self._tracer.root("router.swap", force=True,
                                            generation=target)
            prepared: dict[int, object] = {}
            for rep in self._replicas:
                gw = rep.gateway
                if rep.state == DEAD or gw._batcher.closed or not gw._batcher.worker_alive:
                    continue          # revived replicas re-sync via the monitor
                prep_sp = None if swap_sp is None else swap_sp.child(
                    "swap.prepare", replica=rep.rid)
                try:
                    if self.fault_injection._should_fail_swap(rep.rid):
                        raise InjectedFailure(
                            f"injected swap-prepare failure on replica {rep.rid}"
                        )
                    prepared[rep.rid] = prepare(gw, target)
                    if prep_sp is not None:
                        prep_sp.end(outcome="ok")
                except Exception:
                    # prepare is side-effect-free for serving: the replica
                    # keeps answering its current generation
                    if prep_sp is not None:
                        prep_sp.end(outcome="failed")
                    self.metrics.record_swap_prepare_failure()
                    if rep.state == HEALTHY:
                        rep.state = SUSPECT
                    # stamped, as a kill is: until the commit below moves the
                    # target, the stale replica's generation still equals it,
                    # and the monitor would re-admit it at once
                    rep.last_failure_t = time.perf_counter()
            if not prepared:
                if swap_sp is not None:
                    swap_sp.end(outcome="no_replica_prepared")
                raise RuntimeError(
                    "coordinated hot-swap failed: no replica completed prepare"
                )
            for rid, gen in prepared.items():
                commit_sp = None if swap_sp is None else swap_sp.child(
                    "swap.commit", replica=rid)
                self._replicas[rid].gateway.commit_swap(gen)
                if commit_sp is not None:
                    commit_sp.end()
            self._target_generation = target
            self._target_rulebook = rulebook
            self.metrics.record_coordinated_swap()
            self.metrics.mark_generation_commit()   # freshness clock restarts
            if swap_sp is not None:
                swap_sp.end(outcome="ok", prepared=len(prepared))
        self._observe_lag()
        return target, sorted(prepared)

    # ------------------------------------------------------- alert reactions --
    def handle_alert(self, event) -> None:
        """SLO-alert subscriber (§14): measurement → enforcement, closed loop.

        Wire with ``evaluator.subscribe(router.handle_alert)``. Reactions
        key on the alert's semantic ``signal``, not the spec name:

        * ``availability`` — warn/page tighten admission (brownout level
          1/2, see :meth:`submit`); a clear lifts the brownout.
        * ``generation_lag`` / ``freshness`` — a burning staleness SLO
          triggers an immediate replica re-sync instead of waiting for the
          monitor's next pass.

        Exceptions must not escape into the evaluator's emit path, so the
        whole body is defensive — an unknown signal is ignored."""
        self._leader_only("handle_alert")
        signal = getattr(event, "signal", "")
        severity = getattr(event, "severity", "ok")
        if signal == "availability":
            self._brownout_level = {"warn": 1, "page": 2}.get(severity, 0)
        elif signal in ("generation_lag", "freshness") and severity != "ok":
            self.metrics.record_alert_resync()
            self._resync_lagging()
            self._observe_lag()

    @property
    def brownout_level(self) -> int:
        """Current alert-driven admission tightening (0 = normal)."""
        return self._brownout_level

    @property
    def replicas(self) -> list:
        """The live :class:`Replica` wrappers — read-only, for observability
        surfaces that want each replica's gateway metrics registry."""
        return list(self._replicas)

    @property
    def generation(self) -> int:
        """The coordinated target generation (replicas may lag — see
        ``stats()['replicas']`` / ``max_generation_lag``); on a mesh
        follower, the lowest generation its replicas serve."""
        if not self.leader:
            return min(rep.gateway.generation for rep in self._replicas)
        return self._target_generation

    def _attach(self, controller) -> None:
        """A mesh ``RefreshController`` of this router: each follower
        replica places the rulebook its rank mined when the leader says so."""
        for rep in self._replicas:
            rep.gateway._attach(controller)

    # -------------------------------------------------------------- stats --
    def stats(self) -> dict:
        self._leader_only("stats")
        out = self.metrics.snapshot()
        # the replica-side latency view: the N gateway histograms MERGED
        # (bucket-wise addition ≡ recording the union of their samples, §13)
        # instead of re-measured — attempt latency across the whole set
        out["replica_latency"] = Histogram.merged(
            [rep.gateway.metrics.latency for rep in self._replicas]
        ).snapshot()
        out["target_generation"] = self._target_generation
        out["num_replicas"] = len(self._replicas)
        out["brownout_level"] = self._brownout_level
        out["replicas"] = [
            {
                "id": rep.rid,
                "state": rep.state,
                "generation": rep.gateway.generation,
                "worker_alive": rep.gateway._batcher.worker_alive,
                "consecutive_failures": rep.consecutive_failures,
                "gateway": rep.gateway.stats(),
            }
            for rep in self._replicas
        ]
        if self.supervisor is not None:
            out["supervisor"] = self.supervisor.stats()
        return out

    # ---------------------------------------------------------- lifecycle --
    def close(self) -> None:
        """Stop admitting; flush every replica; fail anything still pending
        (retry-parked or in flight) with a typed exception — never a hang.
        On a mesh the leader's close stops each replica's followers; a
        follower's waits for that and raises what ended a follow loop."""
        if self._closed:
            return
        self._closed = True
        if not self.leader:
            errors = []
            for rep in self._replicas:
                try:
                    rep.gateway.close()
                except BaseException as e:  # noqa: BLE001 — raised once every replica is closed
                    errors.append(e)
            if errors:
                raise errors[0]
            return
        if self.supervisor is not None:
            self.supervisor.close()
        self._stop_monitor.set()
        self._monitor.join(timeout=5.0)
        for rep in self._replicas:
            rep.gateway.close()     # flushes admitted work; callbacks fire
        self._stop_driver.set()
        self._driver.join(timeout=5.0)
        with self._lock:
            heap, self._heap = self._heap, []
            inflight, self._inflight = self._inflight, {}
        for _, _, task in heap:
            self._finish(task, exc=AdmissionRejected("router closed"))
        for task, rid, _ in inflight.values():
            self._finish(task, exc=WorkerCrashed(
                f"router closed with attempt in flight on replica {rid}"
            ))

    def __enter__(self) -> "Router":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    # ----------------------------------------------------------- dispatch --
    def _candidates(self, task: _RouterTask) -> list[int]:
        """Ring-order candidates: owner-first on the first attempt (cache
        affinity even for a suspect owner), healthy-first on retries."""
        pref = task.pref
        start = task.cursor % len(pref)
        order = pref[start:] + pref[:start]
        avail = [rid for rid in order if self._replicas[rid].available]
        if task.attempts == 0:
            return avail
        healthy = [rid for rid in avail if self._replicas[rid].state == HEALTHY]
        rest = [rid for rid in avail if self._replicas[rid].state != HEALTHY]
        return healthy + rest

    def _try_dispatch(self, task: _RouterTask) -> bool:
        """Hand the task to the first candidate that admits it. Returns True
        when the task reached a terminal state OR an attempt is in flight;
        False when every candidate is dead/saturated."""
        now = time.perf_counter()
        if task.deadline is not None and now >= task.deadline:
            self._finish(task, exc=DeadlineExceeded(
                f"deadline passed before attempt {task.attempts + 1}"
            ), deadline=True)
            return True
        remaining_ms = None if task.deadline is None else max(
            0.0, (task.deadline - now) * 1e3
        )
        for rid in self._candidates(task):
            gw = self._replicas[rid].gateway
            att = None
            if task.span is not None:
                att = self._tracer.child(task.span, "router.attempt",
                                         replica=rid, attempt=task.attempts + 1)
            try:
                inner = gw.submit(task.packed, task.top_k, deadline_ms=remaining_ms,
                                  _span_parent=att)
            except AdmissionRejected:
                if att is not None:
                    att.end(outcome="rejected")
                continue            # saturated/closed: spill to the next candidate
            task.att_span = att
            task.attempts += 1
            task.cursor += 1
            token = next(self._token)
            timeout_at = now + self._attempt_timeout
            if task.deadline is not None:
                timeout_at = min(timeout_at, task.deadline)
            with self._lock:
                self._inflight[token] = (task, rid, timeout_at)
            inner.add_done_callback(
                functools.partial(self._on_attempt_done, token, rid, task)
            )
            return True
        return False

    def _on_attempt_done(self, token: int, rid: int, task: _RouterTask, fut) -> None:
        with self._lock:
            claimed = self._inflight.pop(token, None) is not None
        if not claimed:
            return    # watchdog already abandoned this attempt; late answer moot
        rep = self._replicas[rid]
        exc = fut.exception()
        if task.att_span is not None:
            task.att_span.end(
                outcome="ok" if exc is None else type(exc).__name__)
        if exc is None:
            rep.note_success()
            resp = fut.result()
            self._finish(task, result=dataclasses.replace(
                resp, latency_s=time.perf_counter() - task.t_submit
            ))
        elif isinstance(exc, DeadlineExceeded):
            # expired in the replica's queue: terminal, and not the
            # replica's fault — no failure note
            self._finish(task, exc=exc, deadline=True)
        else:
            if not isinstance(exc, AdmissionRejected):
                rep.note_failure(self._suspect_after)
            self._retry_or_fail(task, exc)

    def _retry_or_fail(self, task: _RouterTask, exc: BaseException) -> None:
        now = time.perf_counter()
        if task.outer.done():
            return
        if task.deadline is not None and now >= task.deadline:
            self._finish(task, exc=DeadlineExceeded(
                f"deadline passed after {task.attempts} attempt(s); last: {exc!r}"
            ), deadline=True)
            return
        if self._closed or task.attempts > self.fault.max_retries:
            self._finish(task, exc=exc, exhausted=not self._closed)
            return
        self.metrics.record_failover()
        task.t_parked = now
        delay = retry_delay(self.fault, max(0, task.attempts - 1))
        with self._lock:
            heapq.heappush(self._heap, (now + delay, next(self._seq), task))

    def _finish(self, task: _RouterTask, *, result=None, exc=None,
                deadline: bool = False, exhausted: bool = False) -> bool:
        with task.lock:
            if task.outer.done():
                return False
            if exc is None:
                task.outer.set_result(result)
            else:
                task.outer.set_exception(exc)
        if exc is None:
            self.metrics.record_completed(result.latency_s)
        else:
            self.metrics.record_failed(deadline=deadline, exhausted=exhausted)
        if task.att_span is not None:
            task.att_span.end()       # idempotent: usually already closed
        if task.span is not None:
            task.span.end(
                outcome="ok" if exc is None else type(exc).__name__,
                attempts=task.attempts,
                latency_ms=(time.perf_counter() - task.t_submit) * 1e3,
            )
        return True

    # -------------------------------------------------- driver + watchdog --
    def _drive(self) -> None:
        """Pop due retries and time out unresponsive in-flight attempts."""
        while not self._stop_driver.wait(0.005):
            now = time.perf_counter()
            due: list[_RouterTask] = []
            timed_out: list[tuple] = []
            with self._lock:
                while self._heap and self._heap[0][0] <= now:
                    due.append(heapq.heappop(self._heap)[2])
                expired = [t for t, (_, _, at) in self._inflight.items() if now >= at]
                for t in expired:
                    timed_out.append(self._inflight.pop(t))
            for task in due:
                if task.outer.done():
                    continue
                if task.span is not None and task.t_parked:
                    # the failover gap: parked after a failed attempt until
                    # redispatched to the next candidate
                    self._tracer.add_span(task.span, "router.failover",
                                          task.t_parked, now,
                                          next_attempt=task.attempts + 1)
                    task.t_parked = 0.0
                if not self._try_dispatch(task):
                    task.attempts += 1    # a burnt retry, not a free spin
                    self._retry_or_fail(
                        task, AdmissionRejected("no replica available for retry")
                    )
            for task, rid, _ in timed_out:
                if task.outer.done():
                    continue
                if task.att_span is not None:
                    task.att_span.end(outcome="timeout")
                self.metrics.record_attempt_timeout()
                self._replicas[rid].note_failure(self._suspect_after)
                self._retry_or_fail(task, WorkerCrashed(
                    f"replica {rid} unresponsive: attempt exceeded "
                    f"{self._attempt_timeout * 1e3:.0f} ms"
                ))

    # ----------------------------------------------------- health monitor --
    def _monitor_loop(self) -> None:
        while not self._stop_monitor.wait(self._monitor_interval):
            self._health_tick()

    def _health_tick(self) -> None:
        now = time.perf_counter()
        for rep in self._replicas:
            gw = rep.gateway
            if rep.state == DEAD:
                continue
            if gw._batcher.closed:
                if rep.mark_dead():
                    self.metrics.record_replica_death()
                continue
            alive = gw._batcher.worker_alive
            if rep.state == HEALTHY and not alive:
                rep.state = SUSPECT      # suspected until the supervisor revives it
                # stamp the kill itself as a failure: without this, a
                # supervisor restart landing within one monitor tick would
                # satisfy the re-healthy check immediately (last_failure_t
                # still at its value from a long-past attempt failure) and
                # the suspect window — the observable health dip — would
                # collapse to milliseconds.
                rep.last_failure_t = now
            elif (
                rep.state == SUSPECT
                and alive
                and now - rep.last_failure_t >= self._healthy_after
                and gw.generation == self._target_generation
            ):
                rep.state = HEALTHY
                rep.consecutive_failures = 0
        healthy = sum(1 for rep in self._replicas if rep.state == HEALTHY)
        self.metrics.set_healthy_ratio(healthy / len(self._replicas))
        self._observe_lag()
        self._resync_lagging()

    def _observe_lag(self) -> None:
        target = self._target_generation
        lag = 0
        for rep in self._replicas:
            if rep.state != DEAD and not rep.gateway._batcher.closed:
                lag = max(lag, target - rep.gateway.generation)
        self.metrics.observe_generation_lag(lag)

    def _resync_lagging(self) -> None:
        """Re-apply the target rulebook on replicas that missed a swap (the
        stale-generation recovery path). Skipped while a coordinated swap
        holds the lock — the swap itself brings everyone current."""
        if not self._swap_lock.acquire(blocking=False):
            return
        try:
            target = self._target_generation
            rb = self._target_rulebook
            for rep in self._replicas:
                gw = rep.gateway
                if (
                    rep.state == DEAD
                    or gw._batcher.closed
                    or not gw._batcher.worker_alive
                    or gw.generation >= target
                ):
                    continue
                if self.fault_injection._should_fail_swap(rep.rid):
                    continue          # injected: stays stale, lag keeps showing
                try:
                    gw.commit_swap(gw.prepare_swap(rb, generation=target))
                    self.metrics.record_resync()
                except Exception:
                    self.metrics.record_swap_prepare_failure()
                    if rep.state == HEALTHY:
                        rep.state = SUSPECT
                    rep.last_failure_t = time.perf_counter()
        finally:
            self._swap_lock.release()

    # --------------------------------------------------------- supervision --
    def _on_replica_gave_up(self, rid: int) -> None:
        """ReplicaSetSupervisor callback: restart storm → replica dead. Its
        batcher was closed, so pending futures already failed explicitly and
        the failover path re-routes them."""
        if self._replicas[rid].mark_dead():
            self.metrics.record_replica_death()
