"""Continuous rulebook refresh: store append → delta mine → hot-swap.

The serving tier has a freshness *gauge* (``generation_age_seconds`` +
its SLO) but nothing in it closes the loop —
rulebooks only changed when an operator re-mined. :class:`RefreshController`
is that loop (DESIGN.md §15):

    appended rows land in the store (``StoreWriter.open_for_append``)
        → the controller's watcher notices the row watermark advance
        → delta mine against the persisted count cache
          (``core.incremental.mine_delta``; full SON re-mine as fallback,
          checkpoint snapshots so a crash mid-delta resumes)
        → ``compile_rulebook``
        → coordinated hot-swap on the target (Gateway or Router — both
          re-stamp ``generation_age_seconds`` at commit)

The controller is deliberately *level-triggered*: each cycle reads the
manifest row count and compares it to the watermark of the last swap, so a
missed poll, a crashed refresh, or many appends coalescing into one refresh
all converge to the same fixed point — serving generation covers store
contents. ``handle_alert`` accepts SLO engine events (signal ``freshness``)
and kicks an immediate cycle, turning a burning freshness budget into a
refresh instead of a page.

On a mesh (``mesh=``, one process a rank) every rank builds the controller
beside its rank of the target: a mesh
:class:`~repro_torch.serving.gateway.Gateway` or a mesh
:class:`~repro_torch.serving.router.Router` on the same ranks (every rank
passes its own), or a target on one device (a ``Gateway`` or ``Router`` on
rank 0, which the other ranks pass as None).  At construction the ranks
exchange what each passed, and every rank raises ``ValueError`` unless they
agree on one of these kinds.  The controller's mesh mines and the target's
serves, as in the JAX package, where the controller mines on its ``mesh``
and the target's ``hot_swap`` places the rulebook on the target's own mesh:
the two may differ in shape (a gateway serving on a 2 x 2 ``("data",
"model")`` mesh, refreshed by a data-parallel (4, 1) mine) or be one mesh;
they only span the same ranks.  ``cfg.data_axes`` and ``cfg.model_axis``
are read on the controller's mesh, the target's ``data_axes`` and
``rule_axis`` on its own.  Each rank thus works on two sets of groups: the
target's, which carry serving (the command stream, the batches'
collectives, the place and the commit), and the controller's own
:attr:`RefreshController.mine_mesh` (a ``Mesh.twin`` of the controller's
mesh, built at construction: never the target's groups, nor those of the
mesh the caller passed), which carry only the mine.

Every cycle on a mesh runs one protocol, whatever the target.  The leader's
(rank 0's) poller decides when to refresh, by the same watermark
hysteresis, and starts the cycle on every rank with a key in the default
group's store (the rows it covers); a follower runs the cycles in a thread
of its own, started with the controller.  Every rank runs the delta mine
(or the full one) on the mine mesh beside serving (on the card, on a CUDA
stream of its own) and compiles the same rulebook (compiling is
deterministic), while the target goes on answering with the serving
generation.  The ranks then exchange their outcomes in the store, keyed by
the cycle, never on the mine mesh.  Only then does the leader swap:
``hot_swap`` on one device; on a mesh target each rank places its block of
the rulebook it mined itself (the gateway's PLACE command, in
``Gateway._swap_mined`` or in each replica of ``Router._swap_mined``), and
the leader commits once every rank holds it.  The leader hands the outcome
(the generation and the replicas committed, or the error) to the followers
through the store, and a follower's ``refresh_now`` returns the generation
once those replicas serve it there.  A cycle that fails on any rank fails
on every rank, and the previous generation keeps serving: a rank that
raises aborts the mine mesh (``Mesh.abort``), so the ranks waiting in one
of its collectives let go within ``launch.mesh.ABORT_POLL_S``, and every
rank then replaces the mine mesh (``Mesh.twin``) and destroys the old
one's groups before the cycle ends, so the next cycle mines on groups no
collective is left in.  ``refresh_now()`` is a collective call: on the
leader it drives a cycle, on a follower it waits for the cycle the leader
drives next and returns its generation once that generation serves there.
``close()`` on the leader ends the followers' loops after a cycle in
flight.  A follower's loop also ends once every follow loop of its mesh
target has (the leader closed the target): no cycle can commit there any
more, and a follower's ``Gateway.close()`` waits for it.
"""

from __future__ import annotations

import datetime
import json
import threading
import time
import traceback

import torch

from repro_torch.core import apriori as ap
from repro_torch.core import incremental as inc
from repro_torch.core import streaming as st
from repro_torch.data.store import open_store
from repro_torch.launch.mesh import MeshAborted, mesh_device
from repro_torch.serving.gateway import Gateway
from repro_torch.serving.metrics import _RegistryMetrics
from repro_torch.serving.rulebook import compile_rulebook


class RefreshMetrics(_RegistryMetrics):
    """Registry-backed refresh counters + the ``refresh_latency_seconds``
    histogram (created by the base bundle), observable through the same
    snapshot/SLO machinery as the gateway/router bundles (§13)."""

    _COUNTER_FIELDS = (
        "triggered",          # refresh cycles started
        "delta",              # served by the incremental path
        "full",               # full re-mine (mode or fallback)
        "noop",               # no new rows since the cache generation
        "failures",
        "rows_folded",        # appended rows folded into the cache
        "novel_reverified",   # candidates re-counted over the base store
        "alert_kicks",        # cycles forced by a freshness SLO alert
    )

    def __init__(self, registry=None):
        super().__init__(registry, prefix="refresh")

    def record_cycle(self, mode: str, seconds: float, rows: int, novel: int) -> None:
        with self._lock:
            self._inc("triggered")
            self._inc(mode)      # "delta" | "full" | "noop"
            self._counters["rows_folded"].inc(rows)
            self._counters["novel_reverified"].inc(novel)
            self.latency.record(seconds)

    def record_failure(self) -> None:
        with self._lock:
            self._inc("triggered")
            self._inc("failures")


class RefreshController:
    """Background driver keeping a serving target's rulebook current with an
    append-only :class:`TransactionStore`.

    ``target`` is anything with ``hot_swap(rulebook) -> generation`` and a
    ``metrics.registry`` (Gateway or Router). ``mode="delta"`` goes through
    :func:`core.incremental.mine_delta` (which itself falls back to a full
    SON re-mine on a cold/invalid cache or an oversized delta);
    ``mode="full"`` always re-mines with the level-wise streamed driver.
    Both mine on ``device`` from the controller's own thread, beside the
    target's dispatch workers; the swap places the new rulebook there too
    (:meth:`Gateway.prepare_swap`).  With ``mesh`` every rank builds the
    controller alike, and the mine runs on every rank on the controller's
    own mesh, beside serving (the module docstring).  The target is then
    this rank's mesh ``Gateway`` or mesh ``Router``, built on this mesh or
    on any other of the same ranks, or a target on one device, which rank
    0 passes and the other ranks pass as None.
    ``min_append_rows`` is the watermark hysteresis: a refresh fires once at
    least that many rows sit above the last swapped watermark.
    """

    def __init__(
        self,
        store_path: str,
        target,
        cfg: ap.AprioriConfig = ap.AprioriConfig(),
        *,
        mesh=None,
        device="cuda",
        chunk_rows: int = 8192,
        prefetch: int = 2,
        min_confidence: float = 0.5,
        score: str = "confidence",
        max_rules: int | None = None,
        mode: str = "delta",
        min_append_rows: int = 1,
        poll_interval_s: float = 0.25,
        max_delta_fraction: float = inc.DEFAULT_MAX_DELTA_FRACTION,
        max_drift_fraction: float = inc.DEFAULT_MAX_DRIFT_FRACTION,
        fault=None,
        checkpoint=True,
        registry=None,
        on_refresh=None,
    ):
        if mode not in ("delta", "full"):
            raise ValueError(f"mode must be delta|full, got {mode!r}")
        self.store_path = store_path
        self.target = target
        self.cfg = cfg
        self.mesh = mesh
        self.device = mesh_device(device, mesh)
        self._on_mesh = mesh is not None and mesh.size > 1
        self.leader = not self._on_mesh or mesh.rank == 0
        placed = getattr(target, "_mesh", None)   # the mesh a mesh Gateway or mesh Router serves on
        # the mine's own groups (building them is a collective call): no
        # collective of the mine shares a group with serving's
        self.mine_mesh = mesh.twin() if self._on_mesh else mesh
        if self._on_mesh:
            self._agree_on_target(target, placed)
        self._placed = self._on_mesh and placed is not None   # each rank places the rulebook it mined
        self.chunk_rows = chunk_rows
        self.prefetch = prefetch
        self.min_confidence = min_confidence
        self.score = score
        self.max_rules = max_rules
        self.mode = mode
        self.min_append_rows = max(1, int(min_append_rows))
        self.poll_interval_s = poll_interval_s
        self.max_delta_fraction = max_delta_fraction
        self.max_drift_fraction = max_drift_fraction
        self.fault = fault
        self.checkpoint = checkpoint
        self.on_refresh = on_refresh
        self.metrics = RefreshMetrics(
            registry if registry is not None
            else getattr(getattr(target, "metrics", None), "registry", None)
        )
        self.history: list[dict] = []
        self.last_error: BaseException | None = None
        # rows the SERVED rulebook covers; a refresh advances it. In delta
        # mode the count cache records exactly that (the initial rulebook
        # came out of build_count_cache), so rows appended BEFORE the
        # controller starts still count as pending; without a cache the
        # store's current size is the best available baseline.
        cache = inc.load_count_cache(open_store(store_path))
        self.watermark = (
            cache.n if (mode == "delta" and cache is not None)
            else open_store(store_path).num_transactions
        )
        self._lock = threading.Lock()        # serializes refresh cycles
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._alert_kick = False
        self._thread: threading.Thread | None = None
        # a follower: the outcome of each cycle the leader drove (generation
        # or error), and how many of them refresh_now() has handed out
        self._outcomes: list = []
        self._handed = 0
        self._cycled = threading.Condition()
        self._stream = None
        self._cycles = 0   # the mine cycles run, alike on every rank
        self._closed = False
        # a follower: what the cycle in flight mined (the target's PLACE
        # command places its rulebook), and the thread that runs the cycles
        self.mined: dict = {}
        self._loop: threading.Thread | None = None
        self._loop_error: BaseException | None = None
        if self._on_mesh:
            # this controller's keys in the default group's store (the first
            # mine mesh's prefix: a rebuilt mine mesh keeps them)
            self._store = self.mine_mesh.store
            if self.device.type == "cuda":
                self._stream = torch.cuda.Stream(self.device)
            if placed is not None:
                target._attach(self)
            if not self.leader:
                self._loop = threading.Thread(target=self._follow_cycles, name="refresh-follower", daemon=True)
                self._loop.start()

    def _agree_on_target(self, target, placed) -> None:
        """Every rank of a mesh, at construction: exchange what each rank
        passed as the target (in the mine mesh's keys of the default
        group's store, on no group) and raise the same ``ValueError`` on
        every rank unless the ranks agree on one of the two kinds."""
        store, rank, size = self.mine_mesh.store, self.mesh.rank, self.mesh.size
        kind = ("None" if target is None else "a target on one device" if placed is None
                else f"a mesh {type(target).__name__} of {placed.size} ranks")
        store.set(f"target/{rank}", kind)
        keys = [f"target/{r}" for r in range(size)]
        store.wait(keys, datetime.timedelta(seconds=self.mine_mesh.timeout_s))
        kinds = [store.get(k).decode() for k in keys]
        if kinds == [kinds[0]] * size and kinds[0].endswith(f" of {size} ranks") \
                or kinds == ["a target on one device"] + ["None"] * (size - 1):
            return
        self.mine_mesh.destroy()
        raise ValueError(
            f"a RefreshController on a mesh of {size} ranks refreshes a mesh Gateway or mesh Router built on any "
            "mesh of the same ranks (every rank passes its own; the controller's mesh mines, the target's serves), "
            "or a target on one device (rank 0 passes it, every other rank passes None); the ranks passed: "
            + ", ".join(f"rank {r} {k}" for r, k in enumerate(kinds)))

    # ------------------------------------------------------------ lifecycle --
    def start(self) -> "RefreshController":
        """Start the poller (on a mesh, the leader's; a follower runs the
        cycles the leader starts)."""
        if self._thread is not None:
            raise RuntimeError("RefreshController already started")
        if not self.leader:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="refresh-controller", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the poller.  On a mesh this ends the cycles too
        (:meth:`close`)."""
        if self._on_mesh:
            self._closed = True
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if not self._on_mesh:
            return
        if self.leader:
            with self._lock:   # after a cycle in flight: the next cycle's start is the stop
                self._store.set(f"refresh/{self._cycles + 1}/start", "stop")
            return
        self._loop.join()
        if self._loop_error is not None:
            raise self._loop_error

    def close(self) -> None:
        """Stop the poller and refresh no more.  On a mesh the leader's
        close waits for a cycle in flight to mine, which then commits
        nothing (its ``refresh_now`` raises on every rank), and ends every
        follower's loop; a follower's close waits for that end and raises
        what ended its loop."""
        self._closed = True
        self.stop()

    def __enter__(self) -> "RefreshController":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop()

    # -------------------------------------------------------------- watcher --
    def _store_rows(self) -> int:
        try:
            return open_store(self.store_path).num_transactions
        except (FileNotFoundError, ValueError):
            return self.watermark   # store mid-rewrite: treat as unchanged

    def pending_rows(self) -> int:
        return max(0, self._store_rows() - self.watermark)

    def _run(self) -> None:
        while not self._stop.is_set():
            kicked, self._alert_kick = self._alert_kick, False
            threshold = 1 if kicked else self.min_append_rows
            if self.pending_rows() >= threshold:
                try:
                    self.refresh_now()
                except Exception:
                    pass   # recorded in metrics/last_error; keep watching
            self._wake.wait(self.poll_interval_s)
            self._wake.clear()

    def handle_alert(self, event) -> None:
        """SLO engine hook: a firing freshness alert forces a cycle even
        below the watermark hysteresis (the freshness loop, closed)."""
        signal = getattr(event, "signal", None) or (
            event.get("signal") if isinstance(event, dict) else None
        )
        severity = getattr(event, "severity", None) or (
            event.get("severity") if isinstance(event, dict) else None
        )
        if signal == "freshness" and severity not in (None, "ok"):
            self.metrics._inc("alert_kicks")
            self._alert_kick = True
            self._wake.set()

    # -------------------------------------------------------------- refresh --
    def refresh_now(self) -> int:
        """Run one synchronous refresh cycle; returns the new serving
        generation. Raises (and counts a failure) if mining/swap fail —
        the previous generation keeps serving either way.  On a mesh it is
        a collective call (the module docstring)."""
        if not self.leader:
            return self._next_followed()
        with self._lock:
            t0 = time.perf_counter()
            try:
                if self._closed:
                    raise RuntimeError(f"the refresh controller is closed; generation "
                                       f"{self.target.generation} keeps serving")
                if self._on_mesh:
                    generation, made, rows = self._drive()
                    rulebook, report = made["rulebook"], made["report"]
                else:
                    store = open_store(self.store_path)
                    rulebook, report = self._mine_and_compile(store)
                    generation, rows = self.target.hot_swap(rulebook), store.num_transactions
            except BaseException as e:
                self.last_error = e
                self.metrics.record_failure()
                raise
            return self._record(generation, rulebook, report, rows, time.perf_counter() - t0)

    def _drive(self) -> tuple:
        """Leader, a cycle on a mesh: start it on every rank (a key in the
        store naming the rows it covers), mine on every rank
        (:meth:`_mine_cycle`), swap the target, and hand the outcome to the
        followers (a key in the store, set whatever happened after the
        mine).  Returns ``(generation, what the cycle made, the rows it
        covers)``.  A closed mesh target refuses the cycle before it
        starts: its followers' loops have ended with it."""
        if self._placed and self.target._closed:
            raise RuntimeError(f"the target is closed; generation {self.target.generation} keeps serving")
        n, rows = self._cycles + 1, open_store(self.store_path).num_transactions
        if n > 2:   # every follower read cycle n - 2's keys before it reported cycle n - 1
            for key in ("start", "outcome"):
                self._store.delete_key(f"refresh/{n - 2}/{key}")
        self._store.set(f"refresh/{n}/start", str(rows))
        made = {}
        errors = self._mine_cycle(rows, made)
        if errors:
            raise RuntimeError(f"generation {self.target.generation} keeps serving: the refresh's mine failed on "
                               f"{len(errors)} rank(s):\n" + "\n".join(errors))
        outcome = dict(error=f"rank 0: the swap of refresh cycle {n} did not end")
        try:
            if self._closed:
                raise RuntimeError(f"the refresh controller was closed during the cycle; generation "
                                   f"{self.target.generation} keeps serving")
            if self._placed:   # each rank places the rulebook it mined
                generation, replicas = self.target._swap_mined(made["rulebook"])
            else:
                generation, replicas = self.target.hot_swap(made["rulebook"]), []
            outcome = dict(generation=generation, replicas=replicas)
        except Exception:   # a closed mesh target ends the followers' loops (:meth:`_follow_cycles`)
            outcome = dict(error=f"rank 0: {traceback.format_exc()}", closed=self._placed and self.target._closed)
            raise
        finally:
            self._store.set(f"refresh/{n}/outcome", json.dumps(outcome))
        return generation, made, rows

    def _gateways(self) -> list:
        """A mesh target's gateways on this rank, by replica id (a mesh
        ``Gateway`` is its own one replica)."""
        return [self.target] if isinstance(self.target, Gateway) else [rep.gateway for rep in self.target.replicas]

    def _await_key(self, key: str) -> str | None:
        """Follower: the value of ``key`` in this controller's store, once
        the leader has set it (no time limit: the leader refreshes when it
        will), or None once every follow loop of a mesh target on this rank
        has ended (the leader closed the target: no cycle commits here any
        more)."""
        while not self._store.check([key]):   # a lost store raises here
            if self._placed and not any(gw._follower.is_alive() for gw in self._gateways()):
                return None
            try:
                self._store.wait([key], datetime.timedelta(seconds=0.1))
            except RuntimeError:   # the wait timed out
                pass
        return self._store.get(key).decode()

    def _follow_cycles(self) -> None:
        """Follower: each cycle the leader starts, until its close or until
        the target no longer follows here.  A cycle whose mine succeeded on
        every rank ends with the leader's outcome: its error, or its
        generation once every replica it committed serves it on this rank.
        A cycle that failed because the leader closed the target ends the
        loop instead, and its ``refresh_now`` raises that the loop ended."""
        try:
            if self.device.type == "cuda":   # the current card is a thread's own
                torch.cuda.set_device(self.device)
            while True:
                n = self._cycles + 1
                start = self._await_key(f"refresh/{n}/start")
                if start in (None, "stop"):
                    return
                t0, rows = time.perf_counter(), int(start)
                self.mined = made = {}
                errors, generation, what = self._mine_cycle(rows, made), None, "the refresh's mine"
                if not errors:
                    got = self._await_key(f"refresh/{n}/outcome")
                    outcome = dict(closed=True) if got is None else json.loads(got)
                    if outcome.get("closed"):
                        return
                    if "error" in outcome:
                        errors, what = [outcome["error"]], "the refresh's swap"
                    else:
                        generation = outcome["generation"]
                        for rid in outcome["replicas"]:
                            self._gateways()[rid]._await_generation(generation)
                self._followed(generation, errors, made, rows, time.perf_counter() - t0, what)
        except BaseException as e:  # noqa: BLE001 — close() re-raises it
            self._loop_error = e

    def _mine_cycle(self, rows: int, made: dict) -> list:
        """Every rank of a mesh, beside serving: check that each sees the
        store at the leader's ``rows``, mine and compile into ``made``
        (collective calls on :attr:`mine_mesh`, launches on this
        controller's CUDA stream), then exchange every rank's outcome
        (:meth:`_exchange`).  Returns the ranks' errors: a rank that failed
        fails the cycle on every rank.  ``made`` is filled before the
        exchange, so once the leader is past it every rank's rulebook is
        ready to place.  A rank that raises aborts the mine mesh, so a rank
        waiting in one of the mine's collectives lets go at once (with no
        error of its own: the aborting rank's is the cycle's); once a
        cycle has failed every rank replaces the mine mesh before it
        returns."""
        self._cycles += 1
        error = None
        try:
            with torch.cuda.stream(self._stream):
                try:
                    seen = open_store(self.store_path).num_transactions
                except (FileNotFoundError, ValueError) as e:
                    seen = f"{type(e).__name__}: {e}"
                views = self.mine_mesh.all_gather_object(seen)
                if any(v != rows for v in views):
                    raise RuntimeError(f"the leader refreshes the store at {rows} rows; the ranks see {views}")
                made["rulebook"], made["report"] = self._mine_and_compile(open_store(self.store_path))
        except MeshAborted:   # a peer failed: its error is the cycle's
            pass
        except Exception:  # noqa: BLE001 — reported to every rank below
            error = f"rank {self.mesh.rank}: {traceback.format_exc()}"
            self.mine_mesh.abort(f"rank {self.mesh.rank}")
        errors = self._exchange(error)
        if errors:
            # a collective call, reached by every rank in this cycle, before
            # the next cycle starts: the old groups may hold a collective
            # that no peer will join
            old, self.mine_mesh = self.mine_mesh, self.mine_mesh.twin()
            old.destroy()
        return errors

    def _exchange(self, error: str | None) -> list:
        """Every rank's outcome of this cycle, through the default group's
        store under the cycle's number (the mine mesh's groups may be
        broken by now): this rank's is set, the others' awaited for at most
        the groups' timeout.  Returns the errors."""
        store, n, rank = self._store, self._cycles, self.mesh.rank
        store.set(f"refresh/{n}/{rank}", error or "")
        if n > 2:   # every rank read cycle n - 2's outcomes before this cycle began
            store.delete_key(f"refresh/{n - 2}/{rank}")
        keys = [f"refresh/{n}/{r}" for r in range(self.mesh.size)]
        try:
            store.wait(keys, datetime.timedelta(seconds=self.mine_mesh.timeout_s))
        except RuntimeError as e:   # the store's timeout: a rank that never reported fails the cycle
            return [f"rank {rank}: the ranks' outcomes of refresh cycle {n} did not all arrive within "
                    f"{self.mine_mesh.timeout_s} s: {e}"]
        return [e for e in (store.get(k).decode() for k in keys) if e]

    def _mine_and_compile(self, store):
        """The cycle's mine (on a mesh, a collective call on the mine mesh)
        and compile."""
        if self.mode == "full":
            res = st.mine_streamed(
                store, self.cfg, device=self.device, mesh=self.mine_mesh,
                chunk_rows=self.chunk_rows, prefetch=self.prefetch,
            )
            report = inc.DeltaReport(
                mode="full", reason="mode_full",
                base_rows=0, delta_rows=store.num_transactions,
                base_shards=0, delta_shards=store.num_partitions,
            )
        else:
            res, report = inc.mine_delta(
                store, self.cfg, self.device,
                chunk_rows=self.chunk_rows, prefetch=self.prefetch,
                fault=self.fault, checkpoint=self.checkpoint,
                resume=True,
                max_delta_fraction=self.max_delta_fraction,
                max_drift_fraction=self.max_drift_fraction,
                mesh=self.mine_mesh,
            )
        rulebook = compile_rulebook(
            res,
            min_confidence=self.min_confidence,
            score=self.score,
            max_rules=self.max_rules,
            num_items=store.num_items,
        )
        return rulebook, report

    def _record(self, generation: int, rulebook, report, rows: int, seconds: float) -> int:
        self.watermark = rows
        self.metrics.record_cycle(
            report.mode, seconds,
            rows=report.delta_rows, novel=report.novel_candidates,
        )
        record = {
            "generation": generation,
            "mode": report.mode,
            "reason": report.reason,
            "seconds": seconds,
            "delta_rows": report.delta_rows,
            "novel_candidates": report.novel_candidates,
            "watermark": self.watermark,
            "rules": int(rulebook.num_rules),
        }
        self.history.append(record)
        if self.on_refresh is not None:
            self.on_refresh(record)
        return generation

    def _followed(self, generation: int | None, errors: list, made: dict, rows: int, seconds: float,
                  what: str) -> None:
        """Follower: a cycle the leader drove has run here (``errors``: it
        failed in ``what``)."""
        if errors:
            outcome = RuntimeError(f"{what} failed:\n" + "\n".join(errors))
            self.last_error = outcome
            self.metrics.record_failure()
        else:
            outcome = self._record(generation, made["rulebook"], made["report"], rows, seconds)
        with self._cycled:
            self._outcomes.append(outcome)
            self._cycled.notify_all()

    def _next_followed(self) -> int:
        """Follower: the next cycle the leader drives, once it has run here."""
        with self._cycled:
            self._handed += 1
            want = self._handed
            while len(self._outcomes) < want:
                if not self._loop.is_alive():
                    raise RuntimeError("the refresh controller's follow loop ended before the refresh") from \
                        self._loop_error
                self._cycled.wait(0.1)
            outcome = self._outcomes[want - 1]
        if isinstance(outcome, BaseException):
            raise outcome
        return outcome

    def stats(self) -> dict:
        return {
            "watermark": self.watermark,
            "pending_rows": self.pending_rows(),
            "cycles": len(self.history),
            "last": self.history[-1] if self.history else None,
        }
