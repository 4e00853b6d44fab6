"""PyTorch port: the nine examples in ``examples/torch/`` run on the CPU at a
small size with their built-in asserts, and what each mines is dict-equal
to the JAX package's ``mine`` of the same data (``distributed_mining`` on a
spawned 2 x 2 CPU mesh).  Without CUDA each one raises unless it is given
``--device cpu``."""

import importlib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402,F401  (both frameworks in one process; only numpy crosses)

from repro.core.apriori import AprioriConfig as JCfg  # noqa: E402
from repro.core.apriori import mine as jax_mine  # noqa: E402
from repro.data.synthetic import QuestConfig as JQuest  # noqa: E402
from repro.data.synthetic import gen_transactions as jax_gen  # noqa: E402

from conftest import REPO_ROOT  # noqa: E402

EXAMPLES = Path(REPO_ROOT) / "examples" / "torch"
NAMES = ["quickstart", "mine_corpus", "serve_rules", "mine_out_of_core", "serve_gateway",
         "serve_refresh", "serve_replicated", "serve_slo", "distributed_mining"]
CPU = ["--device", "cpu"]


@pytest.fixture
def example(monkeypatch):
    """``example(name)`` -> the module ``examples/torch/<name>.py``, importable
    by name (so a spawned rank can unpickle its functions).  Torch runs one
    thread in this process and in the processes an example starts (the
    kill -9 child, spawned ranks): the test workers already share the cores,
    and oversubscribed OpenMP threads slow small ops a hundredfold."""
    monkeypatch.syspath_prepend(str(EXAMPLES))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield importlib.import_module
    torch.set_num_threads(threads)


def quest_dict(n, i, *, seed, avg_len=10.0, **cfg):
    db = jax_gen(JQuest(num_transactions=n, num_items=i, avg_len=avg_len, seed=seed))
    return jax_mine(db, JCfg(count_impl="jnp", **cfg)).as_dict()


def test_all_nine_are_here():
    assert sorted(p.stem for p in EXAMPLES.glob("*.py")) == sorted(NAMES)
    assert sorted(p.stem for p in (EXAMPLES.parent).glob("*.py")) == sorted(NAMES)


@pytest.mark.parametrize("name, argv", [
    ("quickstart", ["--transactions", "60", "--items", "12"]),
    ("mine_corpus", ["--tokens", "2000"]),
    ("serve_rules", ["--transactions", "60", "--items", "16"]),
    ("mine_out_of_core", ["--transactions", "300", "--items", "16", "--chunk-rows", "128"]),
    ("serve_gateway", ["--transactions", "300", "--items", "16"]),
    ("serve_refresh", ["--transactions", "300", "--items", "16"]),
    ("serve_replicated", ["--transactions", "300", "--items", "16"]),
    ("serve_slo", ["--transactions", "300", "--items", "16"]),
    ("distributed_mining", ["--transactions", "60", "--items", "16", "--mesh", "2x2"]),
])
def test_without_cuda_each_raises_unless_asked_for_the_cpu(example, name, argv):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        example(name).main(argv)


def test_quickstart(example):
    res = example("quickstart").main(CPU + ["--transactions", "800", "--items", "40"])
    assert res.total_frequent > 0
    assert res.as_dict() == quest_dict(800, 40, seed=42, avg_len=9, min_support=0.03, max_k=5)


def test_mine_corpus(example):
    from repro.data.corpus import transactions_from_tokens

    res = example("mine_corpus").main(CPU + ["--tokens", "20000"])
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 1000, size=20000)
    tokens[::11], tokens[1::11], tokens[2::11] = 7, 13, 29
    dense, _ = transactions_from_tokens(tokens, window=64, num_items=256)
    assert res.as_dict() == jax_mine(dense, JCfg(min_support=0.6, max_k=4, count_impl="jnp")).as_dict()
    assert max(res.levels) >= 3


def test_serve_rules(example, tmp_path):
    rb = str(tmp_path / "rb.npz")
    argv = CPU + ["--transactions", "1000", "--items", "64", "--num-queries", "256", "--rulebook", rb]
    res = example("serve_rules").main(argv)
    assert res.as_dict() == quest_dict(1000, 64, seed=0, min_support=0.02, max_k=4, representation="packed")
    assert example("serve_rules").main(argv) is None     # the saved rulebook served, no mine


def test_mine_out_of_core_with_kill_resume(example, capsys):
    res = example("mine_out_of_core").main(
        CPU + ["--transactions", "3000", "--items", "64", "--chunk-rows", "256", "--shard-rows", "512",
               "--kill-resume", "--checkpoint-every", "2"])
    out = capsys.readouterr().out
    assert "OUT_OF_CORE_OK" in out and "KILL_RESUME_OK" in out
    assert res.as_dict() == quest_dict(3000, 64, seed=7, min_support=0.02, max_k=4, representation="packed")


def test_distributed_mining_on_a_spawned_2x2_mesh(example, capsys):
    out = example("distributed_mining").main(CPU + ["--mesh", "2x2", "--transactions", "1500",
                                                    "--items", "64"])
    assert "all modes agree" in capsys.readouterr().out
    want = quest_dict(1500, 64, seed=7, min_support=0.02, max_k=5)
    assert out["standalone"].as_dict() == want
    assert len(out["ranks"]) == 4
    for rank in out["ranks"]:
        assert rank["mine"][1] == want and rank["son"][1] == want
