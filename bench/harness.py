"""One run of one cell: set-up, the measured window, the check, the line.

Every piece is found by name under ``bench/``: the cell
(``workloads/<cell>.json``) names its configuration
(``configs/<config>.json``) and its traffic mix (``traffic/<traffic>.json``),
the traffic names its driver (``drivers/<driver>.py``), and every per-layer
metric is a reader of its own (``metrics/<metric>.py``).  A driver has
three functions:

* ``setup(ctx) -> state``: make the inputs from the seed, build the program
  under test and warm the shapes this traffic uses;
* ``window(state, ctx) -> dict``: drive the program for ``ctx.seconds``;
  returns ``metrics`` (end-to-end name -> (value, unit)), ``attempted``,
  ``failed`` and what the readers read;
* ``check(state, result, ctx) -> list``: free the program's state, work the
  answers out again with ``bench/reference`` and return ``(name, value,
  limit)`` for each number compared; the run is correct when every value is
  at most its limit.

A driver whose window runs on spawned ranks returns, besides, ``devices``:
each rank's ``bench/ranks.py`` record, in rank order.  The line's device
report and, in a traced run, the profile are then the ranks' merged
(``ranks.merge``); without it they are this process's own, on one card.

The harness reads ``BENCHMARK.json`` for which metrics a cell reports; a
cell it does not list (a dry run) reports every metric it has.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

from bench import ranks
from bench.ranks import forbidden_modules

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


class MissingPiece(LookupError):
    """A name in a cell points at a file the benchmark does not have."""


def _json(kind: str, name: str) -> dict:
    path = BENCH / kind / f"{name}.json"
    if not path.is_file():
        raise MissingPiece(f"{kind} {name!r}: no file bench/{kind}/{name}.json")
    with open(path) as f:
        return json.load(f)


def load_cell(name: str) -> dict:
    """The cell, with its configuration, traffic and driver resolved."""
    cell = _json("workloads", name)
    for key in ("config", "traffic", "chips", "why"):
        if key not in cell:
            raise MissingPiece(f"workload {name!r}: bench/workloads/{name}.json has no {key!r}")
    config = _json("configs", cell["config"])
    traffic = _json("traffic", cell["traffic"])
    if "driver" not in traffic:
        raise MissingPiece(f"traffic {cell['traffic']!r}: no 'driver'")
    return dict(name=name, cell=cell, config=config, traffic=traffic, driver=load_driver(traffic["driver"]))


def load_driver(name: str):
    if not (BENCH / "drivers" / f"{name}.py").is_file():
        raise MissingPiece(f"driver {name!r}: no file bench/drivers/{name}.py")
    return importlib.import_module(f"bench.drivers.{name}")


def load_reader(name: str):
    """The reader of per-layer metric ``name``: ``read(run) -> float | None``."""
    path = BENCH / "metrics" / f"{name}.py"
    if not path.is_file():
        raise MissingPiece(f"metric {name!r}: no file bench/metrics/{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark_entries() -> dict:
    path = ROOT / "BENCHMARK.json"
    if not path.is_file():
        return {}
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def metric_plan(cell: str) -> tuple[list, list]:
    """(end-to-end entries, per-layer entries) for ``cell``; a cell that
    ``BENCHMARK.json`` does not list reports every metric it has."""
    bench = benchmark_entries()
    if any(w.get("name") == cell for w in bench.get("workloads", [])):
        return ([m for m in bench["end_to_end"] if _applies(m, cell)],
                [m for m in bench["per_layer"] if _applies(m, cell)])
    readers = sorted(p.name[: -len(".py")] for p in (BENCH / "metrics").glob("*.py"))
    return [], [dict(name=n) for n in readers]


@dataclasses.dataclass
class Context:
    """What a driver is handed: the cell's pieces and the run's arguments."""

    cell: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    tmp: str
    limits: dict = dataclasses.field(default_factory=dict)
    log: object = print
    profiler: object = None   # trace.DeviceTrace in a traced run

    def rng_seed(self, *stream) -> list:
        """A NumPy seed sequence of the run's seed and a stream of its own."""
        return [self.seed % (1 << 63), *stream]


def _merge(base: dict, over: dict | None) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda", t0: float | None = None,
             overrides: dict | None = None, log=None) -> dict:
    """One run of cell ``name``; returns the result line as a dict.

    ``device="cpu"`` is the dry path the tests drive (the port's plain
    kernels, tiny sizes through ``overrides``); ``main`` never takes it."""
    t0 = time.perf_counter() if t0 is None else t0
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    piece = load_cell(name)
    over = overrides or {}
    tmp = tempfile.mkdtemp(prefix="bench-")
    traffic = _merge(_merge(piece["traffic"], piece["cell"].get("params")), over.get("traffic"))
    ctx = Context(cell=name, config=_merge(piece["config"], over.get("config")), traffic=traffic,
                  seed=int(seed), seconds=float(seconds), trace=bool(trace), device=device, tmp=tmp,
                  limits=_merge(piece["cell"].get("limits", {}), over.get("limits")), log=log)
    import torch

    driver = piece["driver"]
    try:
        if trace:
            from bench.trace import DeviceTrace

            ctx.profiler = DeviceTrace()
        state = driver.setup(ctx)
        gc.collect()   # set-up's garbage is set-up's: the window starts on a collected heap
        setup_s = time.perf_counter() - t0
        cuda = device == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        result = driver.window(state, ctx)
        if ctx.profiler is not None:
            ctx.profiler.stop()
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        checks = driver.check(state, result, ctx)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    merged = ranks.merge(result["devices"], trace) if "devices" in result else None
    correct = all(v <= lim for _, v, lim in checks)
    e2e, per_layer = metric_plan(name)
    metrics = {}
    if trace:
        run = dict(result, cell=name, config=ctx.config, traffic=ctx.traffic, device=device,
                   reference=result.get("reference", {}),
                   profile=merged["profile"] if merged else ctx.profiler.summary())
        run["peaks"] = _peaks(device)
        for m in per_layer:
            reader = load_reader(m["name"])
            value = reader.read(run)
            if value is not None:
                metrics[m["name"]] = dict(value=float(value), unit=m.get("unit", reader.UNIT))
    else:
        have = dict(result["metrics"], setup_s=(setup_s, "s"))
        names = [m["name"] for m in e2e] or list(have)
        for n in names:
            if n in have:
                metrics[n] = dict(value=float(have[n][0]), unit=have[n][1])
    if merged:
        kind, count, peak = merged["kind"], merged["count"], merged["memory_peak_bytes"]
    else:
        kind, count = torch.cuda.get_device_name(0) if cuda else "cpu", 1
    dev = dict(platform="gpu" if cuda else "cpu", kind=kind, count=count, memory_peak_bytes=int(peak))
    line = dict(correct=bool(correct), attempted=int(result["attempted"]), failed=int(result["failed"]),
                metrics=metrics, device=dev)
    if trace:
        prof = run["profile"]
        dev["busy_s"], dev["window_s"] = prof["busy_s"], prof["window_s"]
        line["breakdown"] = dict(device_ops=prof["device_ops"], idle_gaps=prof["idle_gaps"])
    line["checks"] = {n: dict(value=v, limit=lim) for n, v, lim in checks}
    line["_detail"] = dict(setup_s=setup_s, **result.get("detail", {}))
    if merged:
        line["_detail"].update(ranks=merged["ranks"], forbidden=merged["forbidden"])
    return line


def _peaks(device: str) -> dict | None:
    if device != "cuda":
        return None
    import torch

    from bench.peaks import part

    return part(torch.cuda.get_device_name(0))


def main(argv, t0: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)["cell"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench: the cell needs {cell['chips']} CUDA card(s), this machine has {have}", file=sys.stderr)
        return 2
    from bench.peaks import power_limit

    line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device="cuda", t0=t0)
    detail = line.pop("_detail")
    found = sorted(set(forbidden_modules()) | set(detail.get("forbidden", ())))
    if found:
        print(f"bench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    if line["device"]["count"] < int(cell["chips"]):
        print(f"bench: the cell needs {cell['chips']} card(s), the run used {line['device']['count']}",
              file=sys.stderr)
        return 4
    cards = sorted({r["index"] for r in detail["ranks"]}) if "ranks" in detail else [torch.cuda.current_device()]
    detail.update(card=power_limit(cards), workload=args.workload, seed=args.seed, trace=args.trace)
    out = BENCH / "out"
    out.mkdir(exist_ok=True)
    with open(out / f"{args.workload}.{args.seed}.{args.trace}.json", "w") as f:
        json.dump(dict(detail=detail, line=line), f, default=float)
    print("detail " + json.dumps(detail, default=float), flush=True)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line, default=float), flush=True)
    return 0
