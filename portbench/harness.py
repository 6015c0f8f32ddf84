"""One run of one cell: set-up, the measured window, the per-layer
readers of a traced run, the comparison that decides ``correct``, and the
result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is found by its name in ``BENCHMARK.json``: the configuration's
``file``, ``traffic/<traffic>.json`` (whose ``runner`` names a module of
``runners/``), and ``metrics/<metric>.py`` (a ``read(obs, trace)`` that
returns the metric or None where it finds nothing to read).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

import torch

from portbench import check, devtrace

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
#: top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class RunContext:
    cell: dict
    conf: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float


def process_start() -> float:
    """This process's start on ``time.perf_counter``'s clock (the kernel's
    record of it, to a clock tick)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    age = uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.perf_counter() - age


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _named(entries: list[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell_inputs(spec: dict, name: str, root: Path = ROOT
                ) -> tuple[dict, dict, dict]:
    """(cell, configuration, traffic mix) of the cell ``name``."""
    cell = _named(spec["workloads"], name, "workload")
    entry = _named(spec["configs"], cell["config"], "configuration")
    with open(root / entry["file"]) as f:
        conf = json.load(f)
    with open(HERE / "traffic" / f"{cell['traffic']}.json") as f:
        mix = json.load(f)
    return cell, conf, mix


def runner(mix: dict):
    """The module that runs a mix's kind of traffic, ``runners/<runner>.py``."""
    return importlib.import_module(f"portbench.runners.{mix['runner']}")


def reader(name: str):
    """The per-layer metric's reader, ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def in_cell(metric: dict, cell: dict, spec: dict) -> bool:
    """Whether ``metric`` is reported in ``cell``: its ``workloads``, or
    else every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell["name"] in metric["workloads"]
    if "moves" in metric:
        return in_cell(_named(spec["end_to_end"], metric["moves"],
                              "end-to-end metric"), cell, spec)
    return True


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def execute(spec: dict, rc: RunContext, *, guard: bool = True
            ) -> tuple[dict | None, list[str]]:
    """Run the cell once: (result line or None, lines for standard error).
    ``guard`` refuses a run that holds a forbidden module once its window
    has closed."""
    kind = runner(rc.mix)
    res = kind.run(rc)
    if guard and forbidden_modules():
        return None, ["modules of jax or the JAX package are loaded: "
                      + " ".join(forbidden_modules())]
    cell = rc.cell
    if rc.trace:
        metrics = {}
        for m in spec["per_layer"]:
            if not in_cell(m, cell, spec) or "obs" not in res:
                continue
            value = reader(m["name"])(res["obs"], res["trace"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": res["e2e"][m["name"]],
                               "unit": m["unit"]}
                   for m in spec["end_to_end"] if in_cell(m, cell, spec)}
    on_card = rc.device.type == "cuda"
    device = {"platform": "gpu" if on_card else rc.device.type,
              "kind": (torch.cuda.get_device_name(rc.device) if on_card
                       else "cpu"),
              "count": cell["chips"], "memory_peak_bytes": res["peak_bytes"]}
    line = {"correct": False, "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics, "device": device}
    if "trace" in res:
        device["busy_s"] = res["trace"]["busy_s"]
        device["window_s"] = res["trace"]["window_s"]
        line["breakdown"] = devtrace.breakdown(res["trace"])
    res.pop("obs", None)
    res.pop("trace", None)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    readings = kind.check(rc, res)
    ok, table = check.judge(readings, rc.conf["limits"][rc.mix["runner"]])
    line["correct"] = ok and res["failed"] == 0
    line["checks"] = table
    err = res.get("notes", []) + [
        f"check {k}: {v['value']!r} limit {v['limit']!r}"
        for k, v in table.items()]
    err.append(f"check failed: {res['failed']} of {res['attempted']}")
    return line, err


def parse(argv: list[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="portbench/run.py",
                                description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv: list[str], t_start: float) -> int:
    args = parse(argv)
    spec = load_spec()
    cell, conf, mix = cell_inputs(spec, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        t_start = process_start()
    except (OSError, ValueError, IndexError):
        pass
    rc = RunContext(cell=cell, conf=conf, mix=mix, seed=args.seed,
                    seconds=args.seconds, trace=bool(args.trace),
                    device=torch.device("cuda", 0), t_start=t_start)
    line, err = execute(spec, rc)
    for e in err:
        print(e, file=sys.stderr)
    if line is None:
        return 3
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    return 0
