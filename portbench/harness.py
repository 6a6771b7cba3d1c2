"""One run of one cell: parse the arguments, find the cell's configuration,
traffic and metrics by name, set up, measure, check, print.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (with ``--trace 1`` also
``breakdown``), and last ``checked``: each number compared beside its
limit, which the last lines of standard error repeat.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "topo_audio_autoencoder_tpu")


def parse(argv):
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(bench: dict, workload: str) -> tuple:
    """(entry, configuration, traffic, spec) of ``workload``, each found by
    name: ``configs/<config>.json`` (the model), ``traffic/<traffic>.json``
    (the mix, whose ``kind`` names its driver) and ``cells/<workload>.json``
    (the cell's precision, control, peak and the limits of its check)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"portbench: no workload {workload!r} in BENCHMARK.json ({sorted(cells)})")
    entry = cells[workload]
    cfg = load_json(PKG / "configs" / f"{entry['config']}.json")
    traffic = load_json(PKG / "traffic" / f"{entry['traffic']}.json")
    spec = load_json(PKG / "cells" / f"{workload}.json")
    return entry, cfg, traffic, spec


def make_cell(torch, cfg: dict, traffic: dict, spec: dict, seed: int, device):
    """The driver of the traffic's ``kind``: ``kinds/<kind>.py``'s ``Cell``."""
    kind = importlib.import_module(f"portbench.kinds.{traffic['kind']}")
    return kind.Cell(torch, cfg, traffic, spec, seed, device)


def cell_metrics(bench: dict, cell: dict) -> tuple:
    """The cell's end-to-end and per-layer metric entries."""
    name = cell["name"]
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}

    def listed(m):
        return name in m["workloads"] if "workloads" in m else m["moves"] in reported

    return e2e, [m for m in bench["per_layer"] if listed(m)]


def metric_reader(name: str):
    """``read(run) -> float | None`` of ``metrics/<name>.py``."""
    path = PKG / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def synchronize(torch, device) -> None:
    if device != "cpu":
        torch.cuda.synchronize()


def measure(torch, cell, seconds: float, trace: bool, profile_calls: int) -> dict:
    """The measured window: calls back to back until ``seconds`` have
    passed on the host clock, then a synchronize. With ``trace``, once half
    the window has passed, ``profile_calls`` calls run under the profiler;
    they, the profiler and the reading of its trace are left out of the
    window's units and seconds. Python's cyclic garbage collector is off
    inside, with the set-up's objects frozen out of its reach before."""
    from . import trace as trace_mod

    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        return _window(torch, cell, seconds, trace, profile_calls, trace_mod)
    finally:
        gc.enable()
        gc.unfreeze()


def _window(torch, cell, seconds, trace, profile_calls, trace_mod) -> dict:
    summary = None
    units, profile_s = 0, 0.0
    t0 = time.perf_counter()
    while True:
        if trace and summary is None and time.perf_counter() - t0 >= seconds / 2:
            t_profile = time.perf_counter()
            cell.profiling = True
            summary = trace_mod.profile(torch, cell.run, profile_calls, cell.unit, cell.device)
            cell.profiling = False
            profile_s = time.perf_counter() - t_profile
        cell.run()
        units += 1
        if time.perf_counter() - t0 - profile_s >= seconds:
            break
    synchronize(torch, cell.device)
    return {"units": units, "window_s": time.perf_counter() - t0 - profile_s, "summary": summary}


class Run:
    """What a per-layer metric's reader reads: the window, its host spans,
    the trace summary and the counts."""

    def __init__(self, cell, window: dict, flops: float, attention: dict, peak: str):
        self.units = window["units"]
        self.window_s = window["window_s"]
        self.summary = window["summary"] or {}
        self.spans = cell.spans
        self.flops_per_unit = flops
        self.attention = attention
        self.peak = peak


def main(argv, t_start: float) -> int:
    args = parse(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    cell_entry, cfg, traffic, spec = cell_files(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell_entry["chips"]:
        print(f"portbench: {args.workload} needs {cell_entry['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(torch, "cuda", bench, cell_entry, cfg, traffic, spec, args, t_start)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    for name, entry in result["checked"].items():
        print(f"check {name}: {entry['value']!r} limit {entry['limit']!r}", file=sys.stderr)
    print(json.dumps(result, default=str), flush=True)
    return 0


def run_cell(torch, device, bench: dict, cell_entry: dict, cfg: dict, traffic: dict, spec: dict, args,
             t_start: float) -> dict:
    """Set up, measure and check one cell on ``device``; the result's
    object."""
    from . import check

    e2e, per_layer = cell_metrics(bench, cell_entry)
    cell = make_cell(torch, cfg, traffic, spec, args.seed, device)
    cell.setup()
    synchronize(torch, device)
    setup_s = time.perf_counter() - t_start
    window = measure(torch, cell, args.seconds, bool(args.trace), traffic["profile_calls"])
    memory_peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    found = forbidden_modules()
    if found:
        raise SystemExit(f"portbench: the run loaded {found}")
    e2e_values = cell.window_metrics(window["units"], window["window_s"])
    tf32 = {"cudnn": torch.backends.cudnn.allow_tf32, "matmul": torch.backends.cuda.matmul.allow_tf32}
    cell.after_window()
    cell.release()
    t_check = time.perf_counter()
    numbers = cell.numbers(cell.reference_readings())
    correct, rows = check.judge(numbers, spec["limits"])
    check_s = time.perf_counter() - t_check
    metrics, breakdown = {}, None
    if args.trace:
        run = Run(cell, window, cell.flops_per_unit(), cell.attention_counts(), spec["mfu_peak"])
        for m in per_layer:
            value = metric_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        s = run.summary
        breakdown = {"device_ops": [[n, v] for n, v in s.get("top_device_ops", [])],
                     "idle_gaps": [[n, v] for n, v in s.get("top_idle_gaps", [])]}
    else:
        e2e_values["setup_s"] = setup_s
        for m in e2e:
            metrics[m["name"]] = {"value": e2e_values[m["name"]], "unit": m["unit"]}
    device_info = {"platform": "gpu" if device != "cpu" else "cpu",
                   "kind": torch.cuda.get_device_name(0) if device != "cpu" else "cpu",
                   "count": cell_entry["chips"], "memory_peak_bytes": memory_peak}
    if args.trace:
        s = window["summary"] or {}
        device_info["busy_s"] = s.get("busy_s", 0.0)
        device_info["window_s"] = s.get("window_s", 0.0)
    notes = {k: v for k, v in e2e_values.items() if k.startswith("_")}
    notes.update(setup_s=setup_s, check_s=check_s, units=window["units"], window_s=window["window_s"],
                 tf32_during_window=tf32, details={k: v[1] for k, v in numbers.items()})
    result = {"correct": bool(correct), "attempted": window["units"], "failed": 0, "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["notes"] = notes
    result["checked"] = {name: {"value": value, "limit": limit} for name, value, limit in rows}
    return result
