"""PyTorch port: streaming Map/Reduce mining over the on-disk store on the
CPU, held against the JAX package (mirrors ``tests/test_streaming.py``;
the mesh path is not ported yet).  Streamed counts equal whole-DB counts
at the reference's (n, chunk_rows) grid in both representations;
``mine_streamed``, ``mine_son_streamed`` (with and without the retrying
executor) and ``count_union_streamed`` are dict-equal to the JAX package's
and to the port's in-memory ``mine``; the card-side encoders
(``unpack_bits_device``, ``place_words``, the packed ``place_db``) are
byte-equal to the host's; an ``obs`` recorder sees the JAX miner's phases
and chunks; and the CLI with ``--store`` prints the JAX CLI's JSON line."""

import importlib
import json
import sys

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from conftest import random_problem  # noqa: E402
from torch_obs_parity import PORT_ONLY_CALLS, PORT_ONLY_PHASES, port_only_counters  # noqa: E402
from repro.core import apriori as japr  # noqa: E402
from repro.core import streaming as jstream  # noqa: E402
from repro.core.itemsets import unpack_bits  # noqa: E402
from repro.data import store as jst  # noqa: E402
from repro.distributed.fault_tolerance import FaultConfig as JFaultConfig  # noqa: E402
from repro_torch.core import apriori as tapr  # noqa: E402
from repro_torch.core import son as tson  # noqa: E402
from repro_torch.core import streaming  # noqa: E402
from repro_torch.core.itemsets import pack_bits  # noqa: E402
from repro_torch.data import store as st  # noqa: E402
from repro_torch.distributed.fault_tolerance import FaultConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
k3 = importlib.import_module("repro_torch.kernels.support_count")


def _cfgs(representation="dense", **kw):
    return (japr.AprioriConfig(count_impl="jnp", representation=representation, **kw),
            tapr.AprioriConfig(representation=representation, **kw))


def _store(dense, path, shard_rows=64):
    return st.ingest_dense(dense, str(path), shard_rows=shard_rows)


def _cands(i, k, size, seed):
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(i, size=(k, size), replace=True), axis=1).astype(np.int32)


# ------------------------------------------------------ card-side encoders ---
@pytest.mark.parametrize("num_items", [1, 31, 33, 1000])
def test_unpack_bits_device_byte_equal(num_items):
    """``unpack_bits_device`` equals the host ``unpack_bits`` on words with
    bit 31 set (F2), to ``num_items`` columns and to widths above and below
    32·W, with the columns past ``num_items`` zero even where the words hold
    bits there."""
    rng = np.random.default_rng(num_items)
    dense = (rng.random((57, num_items)) < 0.5).astype(np.int8)
    dense[0] = 1
    words = pack_bits(dense)
    dirty = words.copy()
    dirty[:, -1] |= np.uint32(0xFFFFFFFF) << np.uint32(num_items % 32) if num_items % 32 else 0
    want = unpack_bits(words, num_items)
    assert np.array_equal(unpack_bits(dirty, num_items), want)
    for w in (words, dirty):
        t = torch.from_numpy(w.view(np.int32))
        assert np.array_equal(ops.unpack_bits_device(t, num_items).numpy(), want)
        for width in (num_items, k3.item_width(num_items), 32 * w.shape[1] + 64):
            got = ops.unpack_bits_device(t, num_items, width, torch.int8).numpy()
            assert got.shape == (57, width) and got.dtype == np.int8
            assert np.array_equal(got[:, :num_items], want) and not got[:, num_items:].any()
    with pytest.raises(ValueError):
        ops.unpack_bits_device(torch.from_numpy(words.view(np.int32)), num_items, num_items - 1)


@pytest.mark.parametrize("num_items", [1, 31, 33, 1000])
def test_place_words_and_packed_place_db_byte_equal(num_items):
    """Item (a): the packed ``place_db`` packs on the device, equal to host
    ``pack_bits``; ``place_words`` hands the words on as they are (packed)
    or unpacked to ``(rows, item_width(I))`` in the operand dtype (dense),
    equal to the dense ``place_db``."""
    rng = np.random.default_rng(num_items + 1)
    dense = (rng.random((300, num_items)) < 0.4).astype(np.int8)
    pcfg = tapr.AprioriConfig(representation="packed")
    words = tapr.place_db(dense, pcfg, "cpu")
    assert words.dtype == torch.int32 and np.array_equal(words.numpy().view(np.uint32), pack_bits(dense))
    assert tapr.place_words(words, num_items, pcfg) is words
    for operand_dtype in k3.DTYPES:
        dcfg = tapr.AprioriConfig(operand_dtype=operand_dtype)
        got = tapr.place_words(words, num_items, dcfg)
        want = tapr.place_db(dense, dcfg, "cpu")
        assert got.shape == (300, k3.item_width(num_items)) and got.dtype == want.dtype
        assert torch.equal(got, want)
        want_np = np.pad(unpack_bits(pack_bits(dense), num_items), ((0, 0), (0, got.shape[1] - num_items)))
        assert np.array_equal(got.to(torch.int8).numpy(), want_np)


def test_packed_place_db_in_row_blocks(monkeypatch):
    """The packing goes in row blocks (``ops.PACK_ROWS``): a DB of several
    blocks and a ragged last one packs as the host does."""
    monkeypatch.setattr(ops, "PACK_ROWS", 64)
    dense = (np.random.default_rng(5).random((64 * 3 + 17, 70)) < 0.5).astype(np.int8)
    words = tapr.place_db(dense, tapr.AprioriConfig(representation="packed"), "cpu")
    assert np.array_equal(words.numpy().view(np.uint32), pack_bits(dense))


# ------------------------------------------------- chunked-count exactness ---
@pytest.mark.parametrize("rep", ["dense", "packed"])
@pytest.mark.parametrize("n,chunk_rows", [(100, 7), (96, 32), (130, 129), (60, 100), (50, 1)])
def test_streamed_counts_equal_whole_db(tmp_path, rep, n, chunk_rows):
    """Streamed counts equal the whole-DB counts of the JAX package and of
    the port's in-memory count, for chunk sizes that divide n, do not,
    exceed n, and single rows."""
    t, _, _ = random_problem(n, 45, 4, seed=n + chunk_rows)
    cands = _cands(45, 23, 3, seed=n)
    jcfg, tcfg = _cfgs(rep, candidate_pad=32)
    s = _store(t, tmp_path / "db", shard_rows=40)
    got = streaming.count_supports_streamed(s, cands, tcfg, device="cpu", chunk_rows=chunk_rows)
    want = japr._count_level(japr.make_count_step(None, jcfg), japr.place_db(t, jcfg, None), cands, 45, jcfg,
                             None)
    mem = tapr._count_level(tapr.make_count_step(tcfg), tapr.place_db(t, tcfg, "cpu"), cands, 45, tcfg)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, mem)


@pytest.mark.parametrize("rep", ["dense", "packed"])
def test_all_padding_chunk_is_inert(rep):
    t, c, lengths = random_problem(40, 64, 9, seed=3)
    cfg = tapr.AprioriConfig(representation=rep)
    step = streaming.make_accum_count_step(cfg, 64)
    words = torch.from_numpy(pack_bits(t).view(np.int32))
    c_dev = (torch.from_numpy(pack_bits(c).view(np.int32)) if rep == "packed"
             else torch.from_numpy(c).to(k3.DTYPES[cfg.operand_dtype][1]))
    len_dev = torch.from_numpy(lengths)
    acc = step(words, c_dev, len_dev, torch.zeros(9, dtype=torch.int32))
    first = acc.clone()
    step(torch.zeros_like(words), c_dev, len_dev, acc)
    assert torch.equal(acc, first)
    jstep = jstream.make_accum_count_step(None, japr.AprioriConfig(count_impl="jnp", representation=rep))
    jt = jnp.asarray(pack_bits(t)) if rep == "packed" else jnp.asarray(t)
    jc = jnp.asarray(pack_bits(c)) if rep == "packed" else jnp.asarray(c)
    want = jstep(jt, jc, jnp.asarray(lengths), jnp.zeros(9, jnp.int32))
    np.testing.assert_array_equal(first.numpy(), np.asarray(want))


def test_multi_pass_candidate_split(tmp_path):
    t, _, _ = random_problem(70, 30, 4, seed=9)
    cands = _cands(30, 40, 2, seed=9)
    jcfg, tcfg = _cfgs(candidate_pad=8, max_candidates_per_pass=16)
    s = _store(t, tmp_path / "db", shard_rows=32)
    got = streaming.count_supports_streamed(s, cands, tcfg, device="cpu", chunk_rows=33)
    want = jstream.count_supports_streamed(jst.open_store(s.path), cands, jcfg, chunk_rows=33)
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------ end-to-end equality ---
@pytest.mark.parametrize("rep,operand_dtype", [("dense", "bf16"), ("dense", "int8"), ("packed", "bf16")])
def test_mine_streamed_matches_jax_and_mine(tmp_path, small_db, rep, operand_dtype):
    jcfg, tcfg = _cfgs(rep, min_support=0.05, max_k=4, operand_dtype=operand_dtype)
    s = _store(small_db, tmp_path / "db", shard_rows=90)
    got = streaming.mine_streamed(s, tcfg, device="cpu", chunk_rows=77)
    want = jstream.mine_streamed(jst.open_store(s.path), jcfg, chunk_rows=77)
    assert got.as_dict() == want.as_dict() == tapr.mine(small_db, tcfg, device="cpu").as_dict()
    assert (got.min_count, got.num_transactions) == (want.min_count, want.num_transactions)


@pytest.mark.parametrize("rep", ["dense", "packed"])
@pytest.mark.parametrize("with_fault", [False, True])
def test_mine_son_streamed_matches_jax_and_mine(tmp_path, small_db, rep, with_fault):
    jcfg, tcfg = _cfgs(rep, min_support=0.05, max_k=4)
    s = _store(small_db, tmp_path / "db", shard_rows=80)
    # no speculative copies: a straggler's copy depends on timing, and the
    # attempts are compared (test_torch_checkpoint covers speculation)
    fault = FaultConfig(max_workers=2, speculative=False) if with_fault else None
    got = streaming.mine_son_streamed(s, tcfg, device="cpu", chunk_rows=64, fault=fault)
    want = jstream.mine_son_streamed(jst.open_store(s.path), jcfg, chunk_rows=64,
                                     fault=JFaultConfig(max_workers=2, speculative=False) if with_fault else None)
    mem = tson.mine_son(small_db, tcfg, device="cpu", num_partitions=4)
    assert got.as_dict() == want.as_dict() == mem.as_dict() == tapr.mine(small_db, tcfg, device="cpu").as_dict()
    assert got.min_count == want.min_count
    if with_fault:
        assert got.fault_report.to_json()["attempts"] == want.fault_report.to_json()["attempts"]
        assert got.fault_report.completed == s.num_partitions
    else:
        assert got.fault_report is None


@pytest.mark.parametrize("rep", ["dense", "packed"])
@pytest.mark.parametrize("shards", [None, (1, 3)])
def test_count_union_streamed_matches_jax(tmp_path, small_db, rep, shards):
    """The phase-2 union count, over the whole store and over a shard range,
    and ``collect_union`` carrying it."""
    jcfg, tcfg = _cfgs(rep, min_support=0.05, max_k=4, candidate_pad=32)
    s = _store(small_db, tmp_path / "db", shard_rows=80)
    union = tson.winners_to_arrays(tson.union_local_winners(
        (s.partition_dense(p) for p in range(s.num_partitions)), tcfg, "cpu"))
    got = streaming.count_union_streamed(s, union, tcfg, device="cpu", chunk_rows=50, shards=shards)
    want = jstream.count_union_streamed(jst.open_store(s.path), union, jcfg, chunk_rows=50, shards=shards)
    assert list(got) == list(want)
    for k in got:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
    if shards is None:
        res = streaming.mine_son_streamed(s, tcfg, device="cpu", chunk_rows=50, collect_union=True)
        jres = jstream.mine_son_streamed(jst.open_store(s.path), jcfg, chunk_rows=50, collect_union=True)
        assert list(res.union_counts) == list(jres.union_counts)
        for k, (cands, counts) in res.union_counts.items():
            assert np.array_equal(cands, jres.union_counts[k][0]) and np.array_equal(counts, got[k])


def test_son_streamed_phase2_single_disk_scan(tmp_path, small_db, monkeypatch):
    cfg = tapr.AprioriConfig(min_support=0.05, max_k=4)
    s = _store(small_db, tmp_path / "db", shard_rows=100)
    calls = []
    orig = s.iter_chunks

    def counting_iter_chunks(*a, **kw):
        calls.append(kw.get("representation"))
        return orig(*a, **kw)

    monkeypatch.setattr(s, "iter_chunks", counting_iter_chunks)
    got = streaming.mine_son_streamed(s, cfg, device="cpu", chunk_rows=64)
    assert calls == ["packed"], "phase 2 re-scanned the store, or read it dense"
    assert got.as_dict() == tapr.mine(small_db, cfg, device="cpu").as_dict()


def test_streamed_worker_failure_raises(tmp_path, small_db, monkeypatch):
    cfg = tapr.AprioriConfig(min_support=0.05, max_k=3)
    s = _store(small_db, tmp_path / "db", shard_rows=100)
    orig = s.iter_chunks

    def flaky_iter_chunks(*a, **kw):
        yield next(iter(orig(*a, **kw)))
        raise OSError("shard read failed")

    monkeypatch.setattr(s, "iter_chunks", flaky_iter_chunks)
    with pytest.raises(OSError, match="shard read failed"):
        streaming.mine_streamed(s, cfg, device="cpu", chunk_rows=64)


def test_mine_streamed_checkpoint_cb_and_resume_state(tmp_path, small_db):
    cfg = tapr.AprioriConfig(min_support=0.05, max_k=4)
    s = _store(small_db, tmp_path / "db")
    full = streaming.mine_streamed(s, cfg, device="cpu")
    seen = {}
    streaming.mine_streamed(s, cfg, device="cpu", checkpoint_cb=lambda k, levels: seen.update({k: dict(levels)}))
    assert set(seen) == set(full.levels)
    resume = {"levels": {k: v for k, v in full.levels.items() if k <= 2}, "next_k": 3}
    assert streaming.mine_streamed(s, cfg, device="cpu", resume_state=resume).as_dict() == full.as_dict()


def test_argument_validation_and_device_rule(tmp_path, small_db):
    s = _store(small_db, tmp_path / "db")
    cfg = tapr.AprioriConfig()
    with pytest.raises(ValueError):
        streaming.mine_streamed(s, cfg, device="cpu", chunk_rows=0)
    with pytest.raises(ValueError):
        streaming.mine_streamed(s, cfg, device="cpu", checkpoint_every_chunks=-1)
    with pytest.raises(ValueError):
        streaming.count_supports_streamed(s, _cands(32, 4, 2, 0), cfg, device="cpu", chunk_rows=0)
    if not torch.cuda.is_available():
        for fn in (streaming.mine_streamed, streaming.mine_son_streamed):
            with pytest.raises(RuntimeError, match="CUDA"):
                fn(s, cfg)


# ------------------------------------------------------------------ obs -----
class _Recorder:
    """Records every observer hook the miners call (names, chunk rows)."""

    def __init__(self):
        self.phases, self.chunks, self.calls = set(), [], []

    def add_phase(self, name, t0, t1):
        assert t1 >= t0
        self.phases.add(name)

    def on_chunk(self, rows):
        self.chunks.append(rows)

    def __getattr__(self, name):
        def hook(*args, **kwargs):
            self.calls.append((name, args))
        return hook


@pytest.mark.parametrize("rep", ["dense", "packed"])
def test_obs_recorder_sees_the_jax_miners_phases_and_chunks(tmp_path, small_db, rep):
    jcfg, tcfg = _cfgs(rep, min_support=0.05, max_k=4)
    s = _store(small_db, tmp_path / "db", shard_rows=80)
    fault = dict(port=FaultConfig(max_workers=1), jax=JFaultConfig(max_workers=1))
    got, want = _Recorder(), _Recorder()
    streaming.mine_streamed(s, tcfg, device="cpu", chunk_rows=70, obs=got)
    jstream.mine_streamed(jst.open_store(s.path), jcfg, chunk_rows=70, obs=want)
    streaming.mine_son_streamed(s, tcfg, device="cpu", chunk_rows=70, obs=got, fault=fault["port"])
    jstream.mine_son_streamed(jst.open_store(s.path), jcfg, chunk_rows=70, obs=want, fault=fault["jax"])
    assert got.phases - PORT_ONLY_PHASES == want.phases >= {"candidate_gen", "prefetch_stall", "count_kernel",
                                                            "host_sync"}
    assert got.phases >= PORT_ONLY_PHASES
    assert got.chunks == want.chunks and len(got.chunks) > 10
    assert sorted(c[0] for c in got.calls if c[0] not in PORT_ONLY_CALLS) == sorted(c[0] for c in want.calls)
    assert {c[0] for c in got.calls} >= PORT_ONLY_CALLS
    assert [c for c in got.calls if c[0].startswith("on_level")] == \
        [c for c in want.calls if c[0].startswith("on_level")]


# ------------------------------------------------------------------ CLI -----
CLI_ARGS = ["--transactions", "1500", "--items", "64", "--min-support", "0.04", "--max-k", "4", "--seed", "3",
            "--stream-chunk-rows", "400", "--shard-rows", "500"]


def _last_json(text):
    line = [ln for ln in text.strip().splitlines() if ln.startswith("{")][-1]
    out = json.loads(line)
    out.pop("seconds")
    return out


@pytest.mark.parametrize("extra", [[], ["--representation", "packed", "--checkpoint-every", "2"],
                                   ["--algo", "son", "--max-partition-retries", "1"]])
def test_cli_store_json_line_matches_jax(tmp_path, capsys, monkeypatch, extra):
    """The CLI with ``--store`` (ingesting, then reopening and resuming where
    checkpoints are on) prints the JAX CLI's ``total_frequent`` and
    ``levels``."""
    from repro.launch import mine as jcli
    from repro_torch.launch import mine as tcli

    monkeypatch.setattr(sys, "argv", ["repro.launch.mine", *CLI_ARGS, *extra, "--store", str(tmp_path / "j")])
    jcli.main()
    want = _last_json(capsys.readouterr().out)
    tcli.main([*CLI_ARGS, *extra, "--store", str(tmp_path / "t"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert _last_json(out) == want and want["total_frequent"] > 0
    assert ("SON fault report" in out) == ("--max-partition-retries" in extra)
    again = [*CLI_ARGS, *extra, "--store", str(tmp_path / "t"), "--device", "cpu"]
    if "--checkpoint-every" in extra:
        again.append("--resume")
    tcli.main(again)
    assert _last_json(capsys.readouterr().out) == want


def test_cli_store_flag_rules():
    from repro_torch.launch import mine as tcli

    for argv in (["--resume"], ["--checkpoint-every", "2"], ["--max-partition-retries", "1"],
                 ["--store", "x", "--max-partition-retries", "1"]):
        with pytest.raises(SystemExit):
            tcli.main(argv)


def _delta_report(text):
    line = [ln for ln in text.splitlines() if ln.startswith("[mine] delta report: ")][-1]
    return json.loads(line.split(": ", 1)[1])


def test_cli_count_cache_then_delta_matches_jax(tmp_path, capsys, monkeypatch):
    """``--count-cache`` seeds the cache, rows are appended, ``--delta``
    folds them in: each step prints the JAX CLI's JSON line, and the delta
    report equals the JAX CLI's."""
    from repro.data.store import append_chunks as jappend
    from repro.launch import mine as jcli
    from repro_torch.data.store import append_chunks as tappend
    from repro_torch.data.synthetic import QuestConfig, gen_transactions
    from repro_torch.launch import mine as tcli

    extra = gen_transactions(QuestConfig(num_transactions=300, num_items=64, seed=9))
    base = [*CLI_ARGS, "--representation", "packed"]
    outs = {}
    for who, store, append in (("jax", tmp_path / "j", jappend), ("port", tmp_path / "t", tappend)):
        lines = []
        for flag in ("--count-cache", "--delta"):
            argv = [*base, "--store", str(store), flag]
            if who == "jax":
                monkeypatch.setattr(sys, "argv", ["repro.launch.mine", *argv])
                jcli.main()
            else:
                tcli.main([*argv, "--device", "cpu"])
            out = capsys.readouterr().out
            lines.append(_last_json(out))
            if flag == "--count-cache":
                assert "[mine] count cache seq=1" in out
                append([extra], str(store))
            else:
                lines.append(_delta_report(out))
        outs[who] = lines
    assert outs["port"] == outs["jax"]
    assert outs["port"][2]["mode"] == "delta" and outs["port"][2]["delta_rows"] == 300


def test_cli_observability_flags(tmp_path, capsys, monkeypatch):
    """``--progress --trace-out --metrics-out``: live progress on stderr, a
    Chrome trace of the mining phases, the job counters the JAX CLI
    writes, and the JSON line unchanged."""
    from repro.launch import mine as jcli
    from repro_torch.launch import mine as tcli

    obs = ["--progress", "--trace-out", str(tmp_path / "trace.json"),
           "--metrics-out", str(tmp_path / "metrics.json")]
    jobs = ["--metrics-out", str(tmp_path / "jmetrics.json")]
    monkeypatch.setattr(sys, "argv", ["repro.launch.mine", *CLI_ARGS, "--store", str(tmp_path / "j"), *jobs])
    jcli.main()
    want = _last_json(capsys.readouterr().out)
    tcli.main([*CLI_ARGS, "--store", str(tmp_path / "t"), "--device", "cpu", *obs])
    cap = capsys.readouterr()
    assert _last_json(cap.out) == want
    assert "[mine] L1" in cap.err and "rows/s" in cap.err
    names = {e["name"] for e in json.load(open(tmp_path / "trace.json"))["traceEvents"]}
    assert {"mine.level", "mine.candidate_gen", "mine.count_kernel", "mine.prefetch_stall"} <= names
    got = json.load(open(tmp_path / "metrics.json"))
    ref = json.load(open(tmp_path / "jmetrics.json"))
    extra = port_only_counters(got["counters"])
    assert sorted(set(got["counters"]) - extra) == sorted(ref["counters"]) and extra <= set(got["counters"])
    timed = [k for k in got["counters"] if k.startswith("mine_phase_seconds")]
    for k in got["counters"]:
        if k not in timed and k not in extra:
            assert got["counters"][k] == ref["counters"][k], k


def test_cli_observability_flags_on_a_dense_mine(tmp_path, capsys):
    """``--trace-out --metrics-out`` without ``--store``: the in-memory
    mine and its rulebook compile record their phases, level counters and
    spans, and the JSON line is the unobserved run's."""
    from repro_torch.launch import mine as tcli

    args = [*CLI_ARGS, "--device", "cpu", "--rulebook", str(tmp_path / "rb.npz")]
    tcli.main(args)
    want = _last_json(capsys.readouterr().out)
    tcli.main([*args, "--trace-out", str(tmp_path / "trace.json"), "--metrics-out", str(tmp_path / "m.json")])
    assert _last_json(capsys.readouterr().out) == want
    counters = json.load(open(tmp_path / "m.json"))["counters"]
    for p in ("candidate_gen", "candidate_join", "candidate_prune", "cand_place", "count_kernel", "host_sync",
              "rules_extract", "rules_sort", "rules_pad"):
        assert counters[f'mine_phase_seconds{{phase="{p}"}}'] > 0.0, p
    for k, n in want["levels"].items():
        assert counters[f'mine_frequent{{level="{k}"}}'] == n
        assert counters[f'mine_candidates{{level="{k}"}}'] >= n
        if int(k) > 1:
            assert counters[f'mine_candidates_joined{{level="{k}"}}'] >= counters[f'mine_candidates{{level="{k}"}}']
    assert counters["mine_levels"] >= len(want["levels"])
    names = {e["name"] for e in json.load(open(tmp_path / "trace.json"))["traceEvents"]}
    assert {"mine.level", "mine.candidate_join", "mine.candidate_prune", "mine.count_kernel",
            "mine.rules_sort"} <= names


def test_cli_delta_and_obs_flag_rules():
    from repro_torch.launch import mine as tcli

    for argv in (["--count-cache"], ["--delta"], ["--algo", "son", "--progress"],
                 ["--algo", "son", "--trace-out", "t.json"], ["--algo", "son", "--metrics-out", "m.json"]):
        with pytest.raises(SystemExit):
            tcli.main(argv)
