"""PyTorch port: API parity with the JAX package for the names module 6 and
its satellites add.  ``core.rules.extract_rules_vectorized``,
``data.synthetic.gen_transaction_lists``, ``data.corpus.transactions_from_tokens``
(byte-equal) and ``kernels.blocked.support_count_blocked`` give the JAX
functions' results; ``repro_torch.data`` and ``repro_torch.kernels`` re-export
the names ``repro.data`` and ``repro.kernels`` do, each behaving as the JAX
one.  ``core.candidates.lex_sort_rows`` and ``core.itemsets.pad_packed``
equal JAX's on random inputs and on empty ones.  Four names have no
counterpart, and each test pins what does their work:
``data.pipeline.batch_spec`` (a JAX ``PartitionSpec``: ``core.mapreduce.
shard_rows`` takes a rank's row block), ``kernels.ops.resolve_impl`` (the
tensors' device picks the route) and ``launch.mesh``'s ``make_auto_mesh`` /
``make_host_mesh`` / ``make_production_mesh`` (``make_mesh`` builds a rank's
mesh; ``host_mesh_shape`` / ``production_mesh_shape`` give their shapes)."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import repro.data as jdata  # noqa: E402
import repro.kernels as jkernels  # noqa: E402
import repro_torch.data as tdata  # noqa: E402
import repro_torch.kernels as tkernels  # noqa: E402
from repro.core import candidates as jcand  # noqa: E402
from repro.core import itemsets as jitems  # noqa: E402
from repro.core import rules as jrules  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.core.apriori import AprioriConfig as JCfg  # noqa: E402
from repro.core.apriori import mine as jax_mine  # noqa: E402
from repro.data import corpus as jcorpus  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.kernels import blocked as jblocked  # noqa: E402
from repro_torch.core import candidates as tcand  # noqa: E402
from repro_torch.core import itemsets as titems  # noqa: E402
from repro_torch.core import rules as trules  # noqa: E402
from repro_torch.core.apriori import AprioriConfig, mine  # noqa: E402
from repro_torch.core.mapreduce import shard_rows  # noqa: E402
from repro_torch.data import corpus as tcorpus  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.kernels import blocked as tblocked  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch.mesh import MeshLayout  # noqa: E402

from conftest import REPO_ROOT, random_problem, subprocess_env  # noqa: E402


def _rule_tuples(rules):
    return [(r.antecedent, r.consequent, r.support, r.confidence, r.lift) for r in rules]


@pytest.mark.parametrize("min_confidence, max_rules, num_items", [(0.5, None, None), (0.3, 25, 40),
                                                                  (0.9, 3, None)])
def test_extract_rules_vectorized_equals_jax(small_db, min_confidence, max_rules, num_items):
    port = mine(small_db, AprioriConfig(min_support=0.05, max_k=4), device="cpu")
    ref = jax_mine(small_db, JCfg(min_support=0.05, max_k=4, count_impl="jnp"))
    got = trules.extract_rules_vectorized(port, min_confidence, max_rules, num_items)
    want = jrules.extract_rules_vectorized(ref, min_confidence, max_rules, num_items)
    assert got and _rule_tuples(got) == _rule_tuples(want)
    assert _rule_tuples(got) == _rule_tuples(trules.extract_rules(port, min_confidence, max_rules))


def test_gen_transaction_lists_equals_jax():
    cfg = dict(num_transactions=200, num_items=48, avg_len=6, seed=5)
    got = tsyn.gen_transaction_lists(tsyn.QuestConfig(**cfg))
    assert got == jsyn.gen_transaction_lists(jsyn.QuestConfig(**cfg))
    assert tsyn.gen_transaction_lists(tsyn.QuestConfig(num_transactions=0)) == []


@pytest.mark.parametrize("size, window, num_items", [(20_000, 64, 256), (5_003, 16, 40), (100, 200, 8)])
def test_transactions_from_tokens_byte_equal(size, window, num_items):
    rng = np.random.default_rng(size)
    tokens = rng.integers(0, 500, size=size)
    tokens[::7] = 3
    got_d, got_v = tcorpus.transactions_from_tokens(tokens, window=window, num_items=num_items)
    want_d, want_v = jcorpus.transactions_from_tokens(tokens, window=window, num_items=num_items)
    for got, want in ((got_d, want_d), (got_v, want_v)):
        assert got.dtype == want.dtype and got.shape == want.shape and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("n, i, k, block_k", [(300, 40, 700, 512), (64, 33, 5, 2), (100, 64, 512, 128)])
def test_blocked_count_equals_jax(n, i, k, block_k):
    t, c, ln = random_problem(n, i, k, seed=k)
    ln[::9] = -1
    got = tblocked.support_count_blocked(torch.from_numpy(t), torch.from_numpy(c), torch.from_numpy(ln),
                                         block_k=block_k)
    want = jblocked.support_count_blocked(jnp.asarray(t), jnp.asarray(c), jnp.asarray(ln), block_k=block_k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _init_names(path):
    tree = ast.parse(Path(path).read_text())
    names = (a.asname or a.name for node in tree.body if isinstance(node, ast.ImportFrom) for a in node.names)
    return sorted(n for n in names if not n.startswith("_"))


@pytest.mark.parametrize("pkg", ["data", "kernels"])
def test_package_re_exports_the_jax_names(pkg):
    names = _init_names(Path(REPO_ROOT) / "src" / "repro" / pkg / "__init__.py")
    port = {"data": tdata, "kernels": tkernels}[pkg]
    assert names == _init_names(Path(REPO_ROOT) / "src" / "repro_torch" / pkg / "__init__.py")
    for name in names:
        assert hasattr(port, name), name


def test_re_exported_names_behave_as_jax():
    cfg = dict(num_transactions=120, num_items=40, seed=3)
    np.testing.assert_array_equal(tdata.gen_transactions(tdata.QuestConfig(**cfg)),
                                  jdata.gen_transactions(jdata.QuestConfig(**cfg)))
    t, c, ln = random_problem(200, 40, 90, seed=1)
    want = np.asarray(jkernels.support_count(jnp.asarray(t), jnp.asarray(c), jnp.asarray(ln), impl="jnp"))
    got = tkernels.support_count(torch.from_numpy(t), torch.from_numpy(c), torch.from_numpy(ln))
    np.testing.assert_array_equal(got.numpy(), want)
    tp = tkernels.pack_bits_device(torch.from_numpy(t))
    cp = tkernels.pack_bits_device(torch.from_numpy(c))
    got_p = tkernels.support_count_packed(tp, cp, torch.from_numpy(ln))
    np.testing.assert_array_equal(got_p.numpy(), want)
    assert tkernels.ops.support_count is tkernels.support_count and tkernels.ref.support_count_blocked is \
        tblocked.support_count_blocked


def test_loading_the_binding_submodules_keeps_the_re_exports():
    code = ("import importlib, repro_torch.kernels as k\n"
            "for name in ('support_count', 'support_count_packed', 'rule_match', 'blocked'):\n"
            "    importlib.import_module('repro_torch.kernels.' + name)\n"
            "assert k.support_count is k.ops.support_count\n"
            "assert k.support_count_packed is k.ops.support_count_packed\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, env=subprocess_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_batch_spec_has_no_counterpart_shard_rows_does_its_work():
    assert not hasattr(tpipe, "batch_spec")
    x = np.arange(24).reshape(12, 2)
    for rank in range(6):
        lay = MeshLayout((3, 2), ("data", "model"), rank=rank)
        want = np.split(x, 3)[lay.coord("data")]
        np.testing.assert_array_equal(shard_rows(x, lay, ("data",)), want)


@pytest.mark.parametrize("rows, cols, seed", [(0, 3, 0), (1, 2, 1), (50, 3, 2), (200, 4, 3)])
def test_lex_sort_rows_equals_jax(rows, cols, seed):
    a = np.random.default_rng(seed).integers(0, 6, size=(rows, cols)).astype(np.int32)
    got, want = tcand.lex_sort_rows(a), jcand.lex_sort_rows(a)
    assert got.dtype == want.dtype and got.shape == want.shape == a.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rows, words, row_multiple, word_multiple", [
    (0, 0, 4, 2), (0, 3, 8, 1), (7, 3, 1, 1), (7, 3, 4, 2), (16, 4, 8, 4), (5, 1, 3, 5)])
def test_pad_packed_equals_jax(rows, words, row_multiple, word_multiple):
    packed = np.random.default_rng(rows * 10 + words).integers(0, 2**32, size=(rows, words), dtype=np.uint32)
    got = titems.pad_packed(packed, row_multiple, word_multiple)
    want = jitems.pad_packed(packed, row_multiple, word_multiple)
    assert got.dtype == want.dtype == np.uint32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_resolve_impl_has_no_counterpart_the_tensors_device_picks():
    """JAX resolves ``"auto"`` by its backend; the port by where each
    call's tensors live: CPU tensors take the plain version under
    ``"auto"``, and ``"kernel"`` refuses them."""
    assert hasattr(jops, "resolve_impl") and not hasattr(tops, "resolve_impl")
    assert tops.IMPLS == ("auto", "kernel", "ref")
    t, c, ln = (torch.from_numpy(x) for x in random_problem(60, 20, 30, seed=4))
    np.testing.assert_array_equal(tops.support_count(t, c, ln, impl="auto").numpy(),
                                  tops.support_count(t, c, ln, impl="ref").numpy())
    with pytest.raises(RuntimeError):
        tops.support_count(t, c, ln, impl="kernel")


def test_mesh_factories_have_no_counterpart_make_mesh_and_the_shapes_do_their_work(monkeypatch):
    names = ("make_auto_mesh", "make_host_mesh", "make_production_mesh")
    assert all(hasattr(jmesh, n) and not hasattr(tmesh, n) for n in names)
    # the shapes the JAX factories would build (256 / 512 devices cannot be
    # faked here): what they hand make_auto_mesh
    monkeypatch.setattr(jmesh, "make_auto_mesh", lambda shape, axes: (tuple(shape), tuple(axes)))
    for multi_pod in (False, True):
        assert tmesh.production_mesh_shape(multi_pod=multi_pod) == jmesh.make_production_mesh(multi_pod=multi_pod)
    assert tmesh.host_mesh_shape() == jmesh.make_host_mesh()
    assert tmesh.host_mesh_shape((1, 4), ("data", "model")) == jmesh.make_host_mesh((1, 4), ("data", "model"))
