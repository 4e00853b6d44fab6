"""PyTorch port: the RefreshController on the CPU.

Mirrors ``tests/test_refresh.py``: the continuous append → delta mine →
hot-swap loop — watermark hysteresis, freshness-alert kick, refresh
metrics, failure isolation, and zero dropped requests across a live
refresh — and holds the refreshed rulebook to the one compiled from a full
re-mine and to the JAX package's controller on the same store."""

import functools
import shutil
import time

import pytest

torch = pytest.importorskip("torch")
import numpy as np  # noqa: E402

from repro.data.synthetic import QuestConfig, gen_transactions  # noqa: E402
from repro_torch.core import apriori as ap  # noqa: E402
from repro_torch.core import incremental as inc  # noqa: E402
from repro_torch.data import store as ds  # noqa: E402
from repro_torch.serving import Gateway as _Gateway  # noqa: E402
from repro_torch.serving import RefreshController as _RefreshController  # noqa: E402
from repro_torch.serving import compile_rulebook  # noqa: E402

NUM_ITEMS = 48
CFG = ap.AprioriConfig(min_support=0.02, max_k=3)
Gateway = functools.partial(_Gateway, device="cpu")
RefreshController = functools.partial(_RefreshController, device="cpu")


def _rows(n, seed):
    return gen_transactions(
        QuestConfig(num_transactions=n, num_items=NUM_ITEMS, seed=seed)
    )


@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
    """A store with a built count cache and generation 0's rulebook, made
    once; each test serves a copy."""
    p = str(tmp_path_factory.mktemp("seeded") / "db")
    s = ds.ingest_dense(_rows(1500, seed=1), p, shard_rows=256)
    res, _ = inc.build_count_cache(s, CFG, "cpu", chunk_rows=300)
    return p, compile_rulebook(res, min_confidence=0.4, num_items=NUM_ITEMS)


@pytest.fixture()
def served(tmp_path, seeded):
    """(store_path, gateway) with a built count cache behind generation 0."""
    src, rb0 = seeded
    p = str(tmp_path / "db")
    shutil.copytree(src, p)
    gw = Gateway(rb0)
    yield p, gw
    gw.close()


def _wait_for(pred, timeout=90.0):
    t0 = time.time()
    while not pred():
        assert time.time() - t0 < timeout, "timed out waiting"
        time.sleep(0.02)


def test_refresh_now_delta_swaps_and_advances_watermark(served):
    p, gw = served
    ctl = RefreshController(p, gw, CFG, chunk_rows=300, min_confidence=0.4)
    ds.append_chunks([_rows(120, seed=2)], p)
    assert ctl.pending_rows() == 120
    gen = ctl.refresh_now()
    assert gen == gw.generation == 1
    assert ctl.watermark == 1620 and ctl.pending_rows() == 0
    last = ctl.history[-1]
    assert last["mode"] == "delta" and last["delta_rows"] == 120
    assert ctl.metrics.delta == 1 and ctl.metrics.rows_folded == 120
    # the served rulebook equals one compiled from a full re-mine
    res, rep = inc.mine_delta(ds.open_store(p), CFG, "cpu", chunk_rows=300)
    assert rep.mode == "noop"   # refresh_now already advanced the cache


def test_background_watermark_trigger_and_hysteresis(served):
    p, gw = served
    with RefreshController(
        p, gw, CFG, chunk_rows=300, min_confidence=0.4,
        min_append_rows=100, poll_interval_s=0.03,
    ) as ctl:
        ds.append_chunks([_rows(40, seed=3)], p)
        time.sleep(0.3)
        assert gw.generation == 0, "below hysteresis: no refresh"
        ds.append_chunks([_rows(80, seed=4)], p)   # 120 pending now
        _wait_for(lambda: gw.generation == 1)
        _wait_for(lambda: ctl.stats()["pending_rows"] == 0)
    assert ctl.metrics.triggered == 1
    assert ctl.history[-1]["delta_rows"] == 120


def test_freshness_alert_forces_refresh_below_hysteresis(served):
    p, gw = served
    with RefreshController(
        p, gw, CFG, chunk_rows=300, min_confidence=0.4,
        min_append_rows=10_000, poll_interval_s=0.03,
    ) as ctl:
        ds.append_chunks([_rows(30, seed=5)], p)
        ctl.handle_alert({"signal": "availability", "severity": "page"})
        ctl.handle_alert({"signal": "freshness", "severity": "ok"})
        time.sleep(0.2)
        assert gw.generation == 0, "only a firing freshness alert kicks"
        ctl.handle_alert({"signal": "freshness", "severity": "ticket"})
        _wait_for(lambda: gw.generation == 1)
    assert ctl.metrics.alert_kicks == 1


def test_refresh_restamps_generation_age(served):
    p, gw = served
    age = gw.metrics.generation_age
    time.sleep(0.3)
    before = age.value
    assert before >= 0.3
    ctl = RefreshController(p, gw, CFG, chunk_rows=300, min_confidence=0.4)
    ds.append_chunks([_rows(60, seed=6)], p)
    ctl.refresh_now()
    assert age.value < before, "the swap must re-stamp the freshness clock"


def test_refresh_failure_keeps_serving_and_counts(served, monkeypatch):
    p, gw = served
    ctl = RefreshController(p, gw, CFG, chunk_rows=300, min_confidence=0.4)
    ds.append_chunks([_rows(50, seed=7)], p)
    monkeypatch.setattr(
        inc, "mine_delta", lambda *a, **kw: (_ for _ in ()).throw(RuntimeError("boom"))
    )
    with pytest.raises(RuntimeError):
        ctl.refresh_now()
    monkeypatch.undo()
    assert gw.generation == 0, "old generation keeps serving"
    assert ctl.metrics.failures == 1 and isinstance(ctl.last_error, RuntimeError)
    assert ctl.pending_rows() == 50, "watermark not advanced by a failure"
    assert ctl.refresh_now() == 1    # and the next cycle succeeds


def test_full_mode_never_touches_the_cache(served):
    p, gw = served
    seq_before = ds.open_store(p).count_cache_meta["seq"]
    ctl = RefreshController(p, gw, CFG, chunk_rows=300, min_confidence=0.4, mode="full")
    ds.append_chunks([_rows(60, seed=8)], p)
    ctl.refresh_now()
    assert gw.generation == 1
    assert ctl.history[-1]["mode"] == "full"
    assert ctl.metrics.full == 1
    assert ds.open_store(p).count_cache_meta["seq"] == seq_before


def test_zero_dropped_requests_across_live_refresh(served):
    """Requests submitted while the delta mine + swap run all resolve, and
    every response names a generation that actually served (0 or 1)."""
    p, gw = served
    baskets = [np.flatnonzero(r).tolist() or [0] for r in _rows(64, seed=9)]
    ds.append_chunks([_rows(120, seed=10)], p)
    with RefreshController(
        p, gw, CFG, chunk_rows=300, min_confidence=0.4, poll_interval_s=0.02
    ):
        generations = set()
        deadline = time.time() + 90
        while gw.generation == 0 and time.time() < deadline:
            for b in baskets[:8]:
                generations.add(gw.submit(b, top_k=4).result().generation)
            time.sleep(0.02)   # paced client: leave the miner thread CPU
        assert gw.generation == 1
        for b in baskets:
            generations.add(gw.submit(b, top_k=4).result().generation)
    assert generations <= {0, 1} and 1 in generations
    m = gw.metrics
    assert m.completed == m.submitted - m.rejected
    assert m.rejected == 0


def test_refresh_metrics_share_target_registry(served):
    p, gw = served
    ctl = RefreshController(p, gw, CFG, chunk_rows=300, min_confidence=0.4)
    snap = gw.metrics.registry.snapshot()
    assert "refresh_triggered" in snap and "refresh_latency_seconds" in snap
    assert ctl.metrics.registry is gw.metrics.registry


# ------------------------------------------------ the refreshed rulebook --
def _columns(rb):
    h = rb.to_host()
    return [np.asarray(getattr(h, f)).tobytes()
            for f in ("ante_packed", "cons_packed", "ante_len", "scores")]


@pytest.mark.parametrize("mode", ["delta", "full"])
def test_served_rulebook_equals_full_remine_and_jax_controller(served, tmp_path, mode):
    """After one refresh cycle the rulebook the gateway serves is, column
    for column, the one compiled from a full re-mine of the grown store,
    and the one the JAX package's controller swaps in on the same store."""
    from repro.core import apriori as jap
    from repro.data import store as jds
    from repro.serving import RefreshController as JRefreshController

    p, gw = served
    pj = str(tmp_path / "jdb")
    shutil.copytree(p, pj)
    extra = _rows(150, seed=11)
    ds.append_chunks([extra], p)
    jds.append_chunks([extra], pj)
    ctl = RefreshController(p, gw, CFG, chunk_rows=300, min_confidence=0.4, mode=mode)
    assert ctl.refresh_now() == 1 and ctl.history[-1]["mode"] == mode
    served_rb = gw._generation.rulebook
    assert served_rb.device.type == "cpu"

    from repro_torch.core.streaming import mine_streamed

    full = mine_streamed(ds.open_store(p), CFG, device="cpu", chunk_rows=300)
    want = compile_rulebook(full, min_confidence=0.4, num_items=NUM_ITEMS)
    assert _columns(served_rb) == _columns(want)

    class _Target:
        """Stands in for the JAX gateway: records the swapped rulebook."""

        metrics = None

        def hot_swap(self, rb):
            self.rb = rb
            return 1

    target = _Target()
    jcfg = jap.AprioriConfig(min_support=0.02, max_k=3, count_impl="jnp")
    JRefreshController(pj, target, jcfg, chunk_rows=300, min_confidence=0.4, mode=mode).refresh_now()
    assert _columns(served_rb)[:3] == [np.asarray(getattr(target.rb, f)).tobytes()
                                       for f in ("ante_packed", "cons_packed", "ante_len")]
    np.testing.assert_allclose(served_rb.to_host().scores, np.asarray(target.rb.scores),
                               rtol=1e-5, atol=1e-6)


def test_controller_needs_cuda_or_explicit_cpu(served):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    p, gw = served
    with pytest.raises(RuntimeError, match="CUDA"):
        _RefreshController(p, gw, CFG)
