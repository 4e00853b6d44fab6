"""What decides ``correct``: every cell's dry run is correct on the sound
program, and comes out not correct when the timed path is broken
underneath (half of the work left out; an answer altered where it is made)
or when the control, the reference one precision below, takes the
program's place."""

import pytest

from bench import control, harness
from bench.tests import tiny

MINE = ["quest-t10i4d100k.mine", "quest-t10i4d100k.mine_stream"]
SERVE = ["quest-t10i4d100k.serve", "quest-t40i10d100k.serve_saturate"]


def _over(cell):
    return harness._merge(tiny.OVERRIDES, tiny.T40) if cell.startswith("quest-t40") else tiny.OVERRIDES


def _run(cell, seed=2**33 + 7):
    return harness.run_cell(cell, seed, 0.25, False, device="cpu", overrides=_over(cell), log=lambda m: None)


@pytest.mark.parametrize("cell", MINE + SERVE)
def test_the_sound_program_is_correct(cell):
    line = _run(cell)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())


def _half_rows(orig):
    def count(t, c, ln, **kw):
        return orig(t[: t.shape[0] // 2].contiguous(), c, ln, **kw)
    return count


def _one_off(orig):
    def count(t, c, ln, **kw):
        out = orig(t, c, ln, **kw).clone()
        out[0] += 1
        return out
    return count


def _half_batch(orig):
    def match(b, *cols, **kw):
        out = orig(b, *cols, **kw).clone()
        out[b.shape[0] // 2 :] = 0
        return out
    return match


def _altered(orig):
    def match(b, *cols, **kw):
        out = orig(b, *cols, **kw).clone()
        out[0] *= 1.01   # one answer of every batch
        return out
    return match


FAULTS = [(MINE[0], "support_count", _half_rows), (MINE[0], "support_count", _one_off),
          (MINE[1], "support_count_packed", _half_rows), (MINE[1], "support_count_packed", _one_off),
          (SERVE[0], "rule_match", _half_batch), (SERVE[0], "rule_match", _altered),
          (SERVE[1], "rule_match", _half_batch), (SERVE[1], "rule_match", _altered)]


@pytest.mark.parametrize("cell,kernel,fault", FAULTS, ids=[f"{c}-{k}-{f.__name__}" for c, k, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(cell, kernel, fault, monkeypatch):
    from repro_torch.kernels import ops

    monkeypatch.setattr(ops, kernel, fault(getattr(ops, kernel)))
    line = _run(cell)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell", [MINE[0], SERVE[0]])
def test_the_control_fails_the_cells_limits(cell):
    piece = harness.load_cell(cell)
    config = harness._merge(piece["config"], tiny.OVERRIDES["config"])
    traffic = harness._merge(harness._merge(piece["traffic"], piece["cell"].get("params")),
                             dict(tiny.OVERRIDES["traffic"], check_sample=300))
    limits = piece["cell"]["limits"]
    numbers = control.control_numbers(config, traffic, 11, "cpu")
    assert any(v > limits[k] for k, v in numbers.items() if k in limits), numbers
