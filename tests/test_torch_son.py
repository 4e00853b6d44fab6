"""PyTorch port: in-memory SON and the mine CLI on the CPU.  ``mine_son`` is
dict-identical to the JAX package's ``mine_son`` and to the level-wise
``mine`` in both representations; the phase-1 union's exchange format is
byte-equal; the paper's all-subsets map matches; and the port's CLI prints
the JAX CLI's final JSON line at default flags and with ``--algo son``."""

import json
import sys

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402,F401
import numpy as np  # noqa: E402

from repro.core import apriori as japr  # noqa: E402
from repro.core import son as json_  # noqa: E402
from repro.data.synthetic import QuestConfig, gen_transactions  # noqa: E402
from repro_torch.core import apriori as tapr  # noqa: E402
from repro_torch.core import son as tson  # noqa: E402


@pytest.fixture(scope="module")
def quest_db():
    return gen_transactions(QuestConfig(num_transactions=2400, num_items=80, avg_len=8, seed=11))


def _cfgs(representation, **kw):
    return (japr.AprioriConfig(count_impl="jnp", representation=representation, **kw),
            tapr.AprioriConfig(representation=representation, **kw))


@pytest.mark.parametrize("representation", ["dense", "packed"])
@pytest.mark.parametrize("partitions", [3, 8])
def test_mine_son_matches_jax_and_mine(small_db, representation, partitions):
    jcfg, tcfg = _cfgs(representation, min_support=0.05, max_k=4)
    jres = json_.mine_son(small_db, jcfg, num_partitions=partitions)
    tres = tson.mine_son(small_db, tcfg, device="cpu", num_partitions=partitions)
    lw = tapr.mine(small_db, tcfg, device="cpu")
    assert tres.as_dict() == jres.as_dict() == lw.as_dict()
    assert (tres.min_count, tres.num_transactions) == (jres.min_count, jres.num_transactions)
    for k, (sets, sup) in tres.levels.items():
        assert sets.dtype == jres.levels[k][0].dtype and sup.dtype == jres.levels[k][1].dtype


@pytest.mark.parametrize("representation", ["dense", "packed"])
def test_mine_son_matches_jax_quest(quest_db, representation):
    jcfg, tcfg = _cfgs(representation, min_support=0.03, max_k=4, candidate_pad=32,
                       max_candidates_per_pass=128)
    jres = json_.mine_son(quest_db, jcfg, num_partitions=8)
    tres = tson.mine_son(quest_db, tcfg, device="cpu", num_partitions=8)
    assert tres.total_frequent > 50 and max(tres.levels) >= 3
    assert tres.as_dict() == jres.as_dict() == tapr.mine(quest_db, tcfg, device="cpu").as_dict()


@pytest.mark.parametrize("operand_dtype", ["bf16", "int8"])
def test_phase1_union_matches_jax(quest_db, operand_dtype):
    """Phase 1 alone: the per-partition winners and their union are the JAX
    package's, and the exchange arrays are byte-equal both ways."""
    jcfg = japr.AprioriConfig(min_support=0.04, max_k=3, count_impl="jnp", operand_dtype=operand_dtype)
    tcfg = tapr.AprioriConfig(min_support=0.04, max_k=3, operand_dtype=operand_dtype)
    parts = np.array_split(quest_db, 5)
    for part in parts[:2]:
        assert tson.local_winners(part, tcfg, device="cpu") == json_.local_winners(part, jcfg)
    assert tson.local_winners(quest_db[:0], tcfg, device="cpu") == {}
    union_t = tson.union_local_winners(parts, tcfg, device="cpu")
    union_j = json_.union_local_winners(parts, jcfg)
    assert union_t == union_j
    arr_t, arr_j = tson.winners_to_arrays(union_t), json_.winners_to_arrays(union_j)
    assert list(arr_t) == list(arr_j)
    for k in arr_t:
        assert arr_t[k].dtype == arr_j[k].dtype and arr_t[k].tobytes() == arr_j[k].tobytes()
    assert tson.arrays_to_winners(arr_j) == json_.arrays_to_winners(arr_t) == union_j
    assert tson.merge_winners([{2: {(0, 1)}}, {2: {(0, 2)}, 3: {(0, 1, 2)}}]) == \
        json_.merge_winners([{2: {(0, 1)}}, {2: {(0, 2)}, 3: {(0, 1, 2)}}])


@pytest.mark.parametrize("representation", ["dense", "packed"])
def test_naive_paper_map_matches_jax(small_db, representation):
    """``use_naive_paper_map=True`` (every k-subset of the frequent items)
    gives the JAX package's result, level-wise and through SON."""
    jcfg, tcfg = _cfgs(representation, min_support=0.08, max_k=3, use_naive_paper_map=True)
    jres = japr.mine(small_db, jcfg)
    tres = tapr.mine(small_db, tcfg, device="cpu")
    assert tres.as_dict() == jres.as_dict() and tres.total_frequent > 0
    assert tson.mine_son(small_db, tcfg, device="cpu", num_partitions=4).as_dict() == \
        json_.mine_son(small_db, jcfg, num_partitions=4).as_dict()


def test_mine_son_needs_cuda_or_explicit_cpu(small_db):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        tson.mine_son(small_db, tapr.AprioriConfig(min_support=0.1, max_k=2))


# ---------------------------------------------------------------- CLI --------
CLI_ARGS = ["--transactions", "1500", "--items", "64", "--min-support", "0.04", "--max-k", "4",
            "--seed", "3"]


def _last_json(text):
    line = [ln for ln in text.strip().splitlines() if ln.startswith("{")][-1]
    out = json.loads(line)
    assert set(out) == {"seconds", "total_frequent", "levels"}
    out.pop("seconds")
    return out


@pytest.mark.parametrize("extra", [[], ["--algo", "son"], ["--algo", "naive_paper", "--max-k", "3"]])
def test_cli_json_line_matches_jax(extra, capsys, monkeypatch):
    """At default representation and impl (dense; by device), the port's
    ``--device cpu`` final JSON line equals the JAX CLI's, ``seconds`` aside."""
    from repro.launch import mine as jcli
    from repro_torch.launch import mine as tcli

    monkeypatch.setattr(sys, "argv", ["repro.launch.mine", *CLI_ARGS, *extra])
    jcli.main()
    want = _last_json(capsys.readouterr().out)
    tcli.main([*CLI_ARGS, *extra, "--device", "cpu"])
    got = _last_json(capsys.readouterr().out)
    assert got == want and got["total_frequent"] > 0
    tcli.main([*CLI_ARGS, *extra, "--device", "cpu", "--representation", "packed", "--impl", "ref"])
    assert _last_json(capsys.readouterr().out) == want
