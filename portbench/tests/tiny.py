"""Tiny stand-ins of the cells for the CPU tests: the cells' configuration,
traffic and cell files with the widths kept and the scale cut (few
vertices, short clips, a handful of clips).

``BENCH`` is ``BENCHMARK.json`` with the codec cell's entries added from
``codec_cell.json``: the codec cell is out of the benchmark (its rate
spreads with the host beyond any bound; PERF.md), and a later PR that
brings it back adds these entries and no code.
"""

from __future__ import annotations

import copy
import json
import types
from pathlib import Path

from portbench import harness

TRAIN = "flagship_n20.train_b128"
CODEC = "packed_n32.codec_b64"


def with_codec(bench: dict) -> dict:
    """A copy of ``bench`` holding the codec cell and its metrics."""
    bench = copy.deepcopy(bench)
    entries = json.loads((Path(__file__).parent / "codec_cell.json").read_text())
    for key, items in entries.items():
        names = {x["name"] for x in bench[key]}
        bench[key] += [x for x in items if x["name"] not in names]
    return bench


BENCH = with_codec(harness.load_json(harness.ROOT / "BENCHMARK.json"))


def shrink(cfg: dict, traffic: dict, spec: dict) -> tuple:
    """Copies of a cell's files cut to a CPU test's size."""
    cfg, traffic, spec = copy.deepcopy(cfg), copy.deepcopy(traffic), copy.deepcopy(spec)
    if cfg["model"].get("pack_capacities"):
        cfg["model"].update(num_vertices=10, max_active_vertices=10, pack_capacities=[0, 0, 60, 40])
    else:
        cfg["model"].update(num_vertices=6, max_active_vertices=6)
    if traffic["kind"] == "train":
        cfg["model"]["num_samples"] = 4096
        spec["compute_dtype"] = "float32"  # a cell's bf16 is measured on the card
        traffic.update(batch=4, group=3, corpus_clips=24, pool_steps=6, check_blocks=2)
    else:
        cfg["model"]["num_samples"] = 8192
        traffic.update(clips=8, pool_requests=3, check_among=3, check_requests=2, check_blocks=4)
    return cfg, traffic, spec


def cell(workload: str, bench: dict = BENCH):
    """(entry, cfg, traffic, spec) of ``workload`` cut to a CPU test's size."""
    entry, cfg, traffic, spec = harness.cell_files(bench, workload)
    return (entry, *shrink(cfg, traffic, spec))


def args(seed: int = 2**31 + 11, seconds: float = 2.0, trace: int = 0):
    return types.SimpleNamespace(seed=seed, seconds=seconds, trace=trace)
