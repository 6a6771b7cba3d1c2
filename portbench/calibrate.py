"""Readings for the limits of ``correct``, many seeds in one process:

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 [--control] [--fault NAME]

For each seed: the program's readings from its first calls and the
reference's, and every number the check can compare (those the cell's
limits name and the others); with ``--control`` the control's numbers (the
reference in the cell's lower precision, put in the program's place);
``--fault`` plants a fault of ``portbench/faults.py`` in the program. One
JSON line a seed. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

sys.dont_write_bytecode = True
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import check, common, faults, harness  # noqa: E402


def program_numbers(torch, cfg, traffic, spec, seed, device) -> tuple:
    """The cell set up and driven through the calls the check reads,
    released; the reference's readings and the program's numbers."""
    cell = harness.make_cell(torch, cfg, traffic, spec, seed, device)
    cell.setup()
    for _ in range(traffic.get("check_among", 0)):
        cell.run()
    cell.release()
    ref = cell.reference_readings()
    return cell, ref, cell.numbers(ref)


def control_numbers(cell, ref: dict) -> dict:
    """The control in the program's place, judged by the reference."""
    ctl = cell.reference_readings(control=True)
    if cell.traffic["kind"] == "train":
        return check.train_numbers(ctl, ref)
    return cell.numbers(ctl)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", choices=faults.NAMES)
    args = p.parse_args(argv)
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    _, cfg, traffic, spec = harness.cell_files(bench, args.workload)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        with faults.plant(args.fault) if args.fault else contextlib.nullcontext():
            cell, ref, numbers = program_numbers(torch, cfg, traffic, spec, seed, "cuda")
        correct, _ = check.judge(numbers, spec["limits"])
        row = {"seed": seed, "fault": args.fault, "correct": bool(correct),
               "program": {k: v[0] for k, v in numbers.items()},
               "detail": {k: v[1] for k, v in numbers.items() if k != "_left_out"},
               "left_out": numbers.get("_left_out", (None, None))[1]}
        if traffic["kind"] == "codec":
            row["density"] = cell.density
        if args.control:
            ctl = control_numbers(cell, ref)
            row["control"] = {k: v[0] for k, v in ctl.items()}
            row["control_detail"] = {k: v[1] for k, v in ctl.items() if k != "_left_out"}
        row["seconds"] = time.perf_counter() - t0
        row["peak_bytes"] = torch.cuda.max_memory_allocated()
        print(json.dumps(row, default=str), flush=True)
        del cell, ref
        common.free(torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
