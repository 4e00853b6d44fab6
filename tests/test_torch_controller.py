"""PyTorch port: the adaptive max-wait controller (serving.controller).

Mirrors ``tests/test_controller.py``: bounded AIMD on the windowed p99,
hold-below-min-samples, clamps — and the port's gateway on the CPU with
its bit-identity contract intact.  The port's copy decides exactly as the
JAX package's does on the same sequence of observations."""

import functools

import pytest

torch = pytest.importorskip("torch")
import numpy as np  # noqa: E402

from repro_torch.obs.registry import Histogram  # noqa: E402
from repro_torch.serving import Gateway as _Gateway  # noqa: E402
from repro_torch.serving import compile_rulebook  # noqa: E402
from repro_torch.serving import recommend as _recommend  # noqa: E402
from repro_torch.serving.controller import AdaptiveMaxWait  # noqa: E402

Gateway = functools.partial(_Gateway, device="cpu")
recommend = functools.partial(_recommend, device="cpu")

NUM_ITEMS = 32


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def make(h=None, **kw):
    h = h if h is not None else Histogram()
    clock = FakeClock()
    kw.setdefault("objective_ms", 5.0)
    kw.setdefault("initial_wait_ms", 8.0)
    kw.setdefault("min_samples", 4)
    ctl = AdaptiveMaxWait(h, now_fn=clock, **kw)
    return ctl, h, clock


def feed(h, ms, n):
    for _ in range(n):
        h.record(ms / 1e3)


# ----------------------------------------------------------------- AIMD ----

def test_p99_over_objective_halves_the_wait():
    ctl, h, clock = make()
    feed(h, 50.0, 20)                     # way over the 5ms objective
    clock.advance(1.0)
    assert ctl.current_wait_s() == pytest.approx(4.0 / 1e3)   # 8 -> 4
    assert ctl.decreases == 1 and ctl.ticks == 1
    assert ctl.last_window_p99_ms > 5.0


def test_p99_under_headroom_steps_up_and_clamps_at_max():
    ctl, h, clock = make(initial_wait_ms=8.0, max_wait_ms=8.25)
    feed(h, 0.5, 20)                      # far under 0.8 * 5ms
    clock.advance(1.0)
    ctl.force_tick()
    assert ctl.current_wait_ms == pytest.approx(8.25)         # +0.25, capped
    feed(h, 0.5, 20)
    ctl.force_tick()
    assert ctl.current_wait_ms == pytest.approx(8.25)         # clamped
    assert ctl.increases == 1             # the no-op step is not counted


def test_dead_band_holds_steady():
    ctl, h, clock = make()                # band = [4ms, 5ms]
    feed(h, 4.5, 20)
    ctl.force_tick()
    assert ctl.current_wait_ms == pytest.approx(8.0)
    assert ctl.ticks == 1 and ctl.increases == 0 and ctl.decreases == 0


def test_decrease_clamps_at_min_wait():
    ctl, h, clock = make(initial_wait_ms=2.0, min_wait_ms=1.5)
    feed(h, 50.0, 20)
    ctl.force_tick()
    assert ctl.current_wait_ms == pytest.approx(1.5)          # 1.0 clamped up
    feed(h, 50.0, 20)
    ctl.force_tick()
    assert ctl.current_wait_ms == pytest.approx(1.5)
    assert ctl.decreases == 1


def test_thin_window_holds_without_resetting_the_window():
    ctl, h, clock = make(min_samples=16)
    feed(h, 50.0, 10)                     # below min_samples
    clock.advance(1.0)
    assert ctl.current_wait_s() == pytest.approx(8.0 / 1e3)   # held
    assert ctl.ticks == 0
    feed(h, 50.0, 10)                     # trickle accumulates: 20 total now
    clock.advance(1.0)
    assert ctl.current_wait_s() == pytest.approx(4.0 / 1e3)   # now it acts
    assert ctl.ticks == 1


def test_interval_gates_reevaluation():
    ctl, h, clock = make(interval_s=0.25)
    feed(h, 50.0, 20)
    clock.advance(0.1)                    # inside the interval: no tick
    assert ctl.current_wait_s() == pytest.approx(8.0 / 1e3)
    clock.advance(0.2)
    assert ctl.current_wait_s() == pytest.approx(4.0 / 1e3)


def test_snapshot_and_validation():
    ctl, _, _ = make()
    snap = ctl.snapshot()
    assert snap["wait_ms"] == 8.0 and snap["objective_ms"] == 5.0
    assert snap["min_wait_ms"] == 0.0 and snap["max_wait_ms"] == 8.0
    with pytest.raises(ValueError):
        AdaptiveMaxWait(Histogram(), objective_ms=0.0, initial_wait_ms=1.0)
    with pytest.raises(ValueError):
        AdaptiveMaxWait(Histogram(), objective_ms=1.0, initial_wait_ms=1.0,
                        decrease_factor=1.0)
    with pytest.raises(ValueError):
        AdaptiveMaxWait(Histogram(), objective_ms=1.0, initial_wait_ms=1.0,
                        min_wait_ms=2.0, max_wait_ms=1.0)


# ------------------------------------------------- gateway integration -----

@pytest.fixture(scope="module")
def rulebook(small_db):
    from repro_torch.core.apriori import AprioriConfig, mine

    return compile_rulebook(
        mine(small_db, AprioriConfig(min_support=0.05, max_k=3, representation="packed"),
             device="cpu"),
        min_confidence=0.3, num_items=NUM_ITEMS,
    )


def test_gateway_wires_controller_and_stays_bit_identical(small_db, rulebook):
    baskets = [np.flatnonzero(row).tolist() for row in small_db[:32]]
    with Gateway(rulebook, max_batch=8, max_wait_ms=5.0, cache_capacity=0,
                 p99_target_ms=1.0) as gw:
        assert gw.wait_controller is not None
        assert gw._batcher._wait_controller is gw.wait_controller
        responses = [(b, gw.query(b, top_k=5)) for b in baskets]
        gw.wait_controller.force_tick()   # guarantee at least one decision
        stats = gw.stats()
    # the controller is live and visible in stats()
    ctl = stats["wait_controller"]
    assert ctl["objective_ms"] == 1.0 and ctl["max_wait_ms"] == 5.0
    assert stats["max_wait_ms"] == ctl["wait_ms"] <= 5.0
    # §10 contract survives adaptation: every response equals the direct
    # batch engine at the answering bucket, no matter what the wait did
    for b, resp in responses:
        direct = recommend(rulebook, [b], top_k=5, batch_size=resp.bucket)
        assert np.array_equal(resp.items, direct.items[0])
        assert np.array_equal(resp.scores, direct.scores[0])


def test_gateway_without_target_keeps_fixed_wait(rulebook):
    with Gateway(rulebook, max_batch=8, max_wait_ms=5.0, cache_capacity=0) as gw:
        assert gw.wait_controller is None
        stats = gw.stats()
    assert stats["max_wait_ms"] == 5.0
    assert "wait_controller" not in stats


# ------------------------------------------------ same decisions as JAX -----
@pytest.mark.parametrize("seed", [0, 1])
def test_decisions_equal_jax_controller(seed):
    """One random sequence of latency observations and clock steps through
    both packages' controllers: every snapshot equal, step by step."""
    from repro.obs.registry import Histogram as JHistogram
    from repro.serving.controller import AdaptiveMaxWait as JAdaptiveMaxWait

    rng = np.random.default_rng(seed)
    t_clock, j_clock = FakeClock(), FakeClock()
    kw = dict(objective_ms=5.0, initial_wait_ms=8.0, min_samples=4)
    th, jh = Histogram(), JHistogram()
    tc = AdaptiveMaxWait(th, now_fn=t_clock, **kw)
    jc = JAdaptiveMaxWait(jh, now_fn=j_clock, **kw)
    for _ in range(60):
        for ms in rng.choice([0.5, 2.0, 4.9, 12.0, 80.0], size=int(rng.integers(0, 12))):
            th.record(float(ms) / 1e3)
            jh.record(float(ms) / 1e3)
        dt = float(rng.choice([0.01, 0.2, 1.0]))
        t_clock.advance(dt)
        j_clock.advance(dt)
        assert tc.current_wait_s() == jc.current_wait_s()
        if rng.random() < 0.2:
            tc.force_tick()
            jc.force_tick()
        assert tc.snapshot() == jc.snapshot()
