"""PyTorch port on the card: the program's device-timed spans against the
profiler.  ``count_kernel`` (CUDA events around a dense mine's K3 passes)
and ``gpu.match`` (CUDA events around each gateway batch's K2 launches)
are held within 15% of the device seconds ``torch.profiler`` gives the
same kernels over the same calls.  Marked ``gpu``; every test skips
without a card.  Run on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_obs.py
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.gpu

AGREE = 0.15


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _kernel_s(prof, tmp_path, names) -> float:
    """Device seconds of the profiled kernels whose name holds one of ``names``."""
    path = tmp_path / "prof.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sum(float(e.get("dur", 0)) for e in events
               if e.get("cat") == "kernel" and any(n in e["name"] for n in names)) / 1e6


def _profile():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def test_count_kernel_phase_is_k3_device_time(cuda, tmp_path):
    """A dense mine whose level 2 counts 499,500 candidates in 8 passes: the
    ``count_kernel`` phase is K3's device time by the profiler."""
    from repro_torch.core.apriori import AprioriConfig, mine
    from repro_torch.obs import MiningObs

    rng = np.random.default_rng(7)
    db = (rng.random((100_000, 1000)) < 0.02).astype(np.int8)
    cfg = AprioriConfig(min_support=0.01, max_k=2, representation="dense")
    plain = mine(db, cfg, device=cuda)   # builds K3
    obs = MiningObs()
    torch.cuda.synchronize()
    with _profile() as prof:
        res = mine(db, cfg, device=cuda, obs=obs)
        torch.cuda.synchronize()
    assert res.as_dict() == plain.as_dict()
    assert obs.counters()['mine_candidates{level="2"}'] == 499_500
    events = obs.counters()['mine_phase_seconds{phase="count_kernel"}']
    k3 = _kernel_s(prof, tmp_path, ("support_count_kernel",))
    assert k3 > 0.01 and abs(events - k3) <= AGREE * k3, (events, k3)


def test_gpu_match_spans_are_k2_device_time(cuda, tmp_path):
    """A gateway over 524,288 random rules answers 1,024 pre-packed
    baskets, 64 at a time, with every request sampled: the ``gpu.match``
    spans sum to K2's device time (compaction and match) by the profiler,
    one span a batch.  (Events bracket the launches, so they also read the
    device waiting on the host between them: a dispatch thread waiting for
    the GIL behind a busy client thread reads that wait too, which is why
    the client sends the next 64 only once a batch is answered.)"""
    from repro_torch.core.itemsets import pack_bits
    from repro_torch.obs import Tracer
    from repro_torch.serving import Gateway
    from repro_torch.serving.rulebook import Rulebook

    items, rules = 512, 1 << 19
    rng = np.random.default_rng(11)
    ante, cons = np.zeros((rules, items), np.int8), np.zeros((rules, items), np.int8)
    sizes = rng.integers(1, 4, rules)
    for m in range(1, 4):
        sized = np.flatnonzero(sizes == m)
        for _ in range(m):
            ante[sized, rng.integers(0, items, sized.size)] = 1
    cons[np.arange(rules), rng.integers(0, items, rules)] = 1
    rb = Rulebook(pack_bits(ante), pack_bits(cons), ante.sum(1).astype(np.int32),
                  np.sort(rng.random(rules).astype(np.float32))[::-1].copy(), items)
    rows = np.zeros((1024, items), np.int8)
    rows[np.arange(1024)[:, None], rng.random((1024, items)).argsort(1)[:, :40]] = 1
    baskets = pack_bits(rows)
    tracer = Tracer(sample_rate=1.0)
    gw = Gateway(rb, device=cuda, max_batch=64, max_wait_ms=50.0, queue_depth=2048, cache_capacity=0,
                 tracer=tracer)
    torch.cuda.synchronize()
    with _profile() as prof:
        for start in range(0, len(baskets), 64):
            for f in [gw.submit(b) for b in baskets[start : start + 64]]:
                f.result(timeout=120)
        batches = gw.stats()["batches"]
        gw.close()
        torch.cuda.synchronize()
    spans = [s for s in tracer.spans() if s.name == "gpu.match"]
    assert len(spans) == len([s for s in tracer.spans() if s.name == "gateway.batch"]) == batches == 16
    events = sum(s.t1 - s.t0 for s in spans)
    k2 = _kernel_s(prof, tmp_path, ("compact_rules_kernel", "rule_match_kernel"))
    assert k2 > 0.01 and abs(events - k2) <= AGREE * k2, (events, k2)
