"""PyTorch port: the four serving examples in ``examples/torch/`` (gateway,
refresh, replicated tier, SLO loop) run on the CPU at a small size with
their built-in asserts, and the rulebook each serves first was mined
dict-equal to the JAX package's ``mine`` of the same data."""

import importlib
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402,F401  (both frameworks in one process; only numpy crosses)

from repro.core.apriori import AprioriConfig as JCfg  # noqa: E402
from repro.core.apriori import mine as jax_mine  # noqa: E402
from repro.data.synthetic import QuestConfig as JQuest  # noqa: E402
from repro.data.synthetic import gen_transactions as jax_gen  # noqa: E402

from conftest import REPO_ROOT  # noqa: E402

EXAMPLES = Path(REPO_ROOT) / "examples" / "torch"
SMALL = ["--device", "cpu", "--transactions", "1500", "--items", "64"]
LOAD = ["--requests", "300", "--concurrency", "4"]


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


def quest_dict(n, i, *, seed, **cfg):
    db = jax_gen(JQuest(num_transactions=n, num_items=i, seed=seed))
    return jax_mine(db, JCfg(count_impl="jnp", representation="packed", **cfg)).as_dict()


@pytest.mark.parametrize("name", ["serve_gateway", "serve_replicated", "serve_slo"])
def test_serving_examples(example, name, capsys):
    res = example(name).main(SMALL + LOAD)
    assert res.as_dict() == quest_dict(1500, 64, seed=0, min_support=0.02, max_k=4)
    assert "300 responses" in capsys.readouterr().out


def test_serve_refresh(example, capsys):
    res = example("serve_refresh").main(["--device", "cpu", "--transactions", "2000", "--items", "64"])
    assert res.as_dict() == quest_dict(2000, 64, seed=1, min_support=0.02, max_k=3)
    out = capsys.readouterr().out
    assert "refresh: mode=delta" in out and "serving generation 1" in out and "mode=noop" in out
