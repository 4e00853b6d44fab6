"""PyTorch port: the serve CLI (``python -m repro_torch.launch.serve``) on the
CPU at a tiny size.

Each run's JSON summary holds the invariants of the verify recipe (zero
drops, exact generations, the killed replica recovered, the refresh went
through the delta path) and has the same keys as the JAX CLI's summary
under the same flags.
"""

import json
import sys

import pytest

torch = pytest.importorskip("torch")

# killing dispatch workers IS the subject of the fault-path runs
pytestmark = pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")

TINY = ["--transactions", "1500", "--items", "48", "--requests", "300", "--concurrency", "6",
        "--shard-rows", "500", "--stream-chunk-rows", "500", "--min-support", "0.03", "--max-k", "3"]


def _run(tmp_path, monkeypatch, capsys, flags, who):
    out = tmp_path / f"{who}.json"
    argv = [*TINY, *flags, "--json", str(out)]
    if who == "jax":
        from repro.launch import serve as cli

        monkeypatch.setattr(sys, "argv", ["repro.launch.serve", *argv])
        cli.main()
    else:
        from repro_torch.launch import serve as cli

        cli.main([*argv, "--device", "cpu"])
    capsys.readouterr()
    return json.loads(out.read_text())


def _zero_drops(s):
    terminal = (s["responses"] + s["rejected"] + s["crashed_requests"]
                + s["deadline_expired_requests"])
    assert terminal == s["requests"]


def _same_keys(got, want):
    assert sorted(got) == sorted(want)
    for key in ("refresh", "slo"):
        if key in want:
            assert sorted(got[key]) == sorted(want[key])
    if want.get("alerts"):
        assert sorted(got["alerts"][0]) == sorted(want["alerts"][0])


@pytest.mark.parametrize("flags", [[], ["--hot-swap-mid-load"],
                                   ["--supervise", "--crash-worker-mid-load"]],
                         ids=["plain", "hot-swap", "crash"])
def test_serve_cli_single_gateway(tmp_path, monkeypatch, capsys, flags):
    s = _run(tmp_path, monkeypatch, capsys, flags, "port")
    _zero_drops(s)
    if "--crash-worker-mid-load" in flags:
        assert s["worker_restarts"] >= 1 and s["crashed_requests"] >= 1
        assert s["responses"] + s["rejected"] + s["crashed_requests"] == s["requests"]
    else:
        assert s["responses"] + s["rejected"] == s["requests"]
    assert s["generations"] == ([0, 1] if "--hot-swap-mid-load" in flags else [0])
    assert 0.0 < s["batch_occupancy"] <= 1.0 and s["qps"] > 0
    if not flags:   # these flags add no summary keys; one JAX run pins them
        _same_keys(s, _run(tmp_path, monkeypatch, capsys, flags, "jax"))


def test_serve_cli_replicated_refresh_slo(tmp_path, monkeypatch, capsys):
    """Two replicas, one killed mid-load, 5% rows appended and delta-mined
    into a coordinated swap under traffic, SLOs evaluated, trace and
    metrics written."""
    flags = ["--replicas", "2", "--kill-replica-mid-load", "--refresh", "delta",
             "--append-mid-load", "0.05", "--slo",
             "--trace-out", str(tmp_path / "trace.json"), "--trace-sample", "1.0",
             "--metrics-out", str(tmp_path / "metrics.json")]
    s = _run(tmp_path, monkeypatch, capsys, flags, "port")
    _zero_drops(s)
    assert s["kills_fired"] == 1 and s["worker_restarts"] >= 1
    assert s["availability"] >= 0.99
    assert s["replica_states"] == ["healthy", "healthy"]
    assert len(set(s["replica_generations"])) == 1
    assert s["generations"] == [0, 1]
    assert s["refresh"]["mode"] == "delta" and s["refresh"]["delta_rows"] == 75
    assert s["refresh"]["appended_rows"] == 75 and s["refresh"]["generation"] == 1
    assert s["alerts_fired"] >= 0 and isinstance(s["slo"], dict)
    names = {e["name"] for e in json.load(open(tmp_path / "trace.json"))["traceEvents"]}
    assert {"router.request", "router.attempt", "gateway.request", "queue.wait",
            "batch.assemble", "device.dispatch", "swap.prepare", "swap.commit"} <= names
    metrics = json.load(open(tmp_path / "metrics.json"))
    assert sorted(metrics) == ["replicas", "router"] and len(metrics["replicas"]) == 2
    jflags = [f for f in flags if not f.startswith(str(tmp_path))]
    jflags = [f for f, nxt in zip(jflags, jflags[1:] + [""])
              if f not in ("--trace-out", "--metrics-out")]
    _same_keys(s, _run(tmp_path, monkeypatch, capsys, jflags, "jax"))


def test_serve_cli_needs_cuda_or_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    from repro_torch.launch import serve as cli

    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(TINY)
