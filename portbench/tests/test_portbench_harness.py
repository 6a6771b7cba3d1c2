"""The harness on the CPU: cells, traffic and metrics found by name, no
JAX in a run, the reference apart from the port, the chip look, and the
check coming out false under each fault a cell can have and under the
control. Tests that need the card are marked ``gpu`` and skip without one.

Run: ``python -m pytest portbench/tests -q``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from portbench import check, faults, harness
from portbench.tests import tiny

ROOT = harness.ROOT


def copy_benchmark(tmp_path):
    """A directory holding only BENCHMARK.json and ``portbench/``."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def test_files_found_by_name(tmp_path):
    """A configuration, a traffic mix, a cell, a traffic kind and a metric
    added as files and entries, with no other file edited, are found."""
    root = copy_benchmark(tmp_path)
    pkg = root / "portbench"
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((pkg / "configs" / "flagship_n20.json").read_text())
    cfg["model"]["num_vertices"] = 21
    (pkg / "configs" / "flagship_n21.json").write_text(json.dumps(cfg))
    traffic = json.loads((pkg / "traffic" / "train_b128.json").read_text())
    traffic.update(batch=64, kind="replay")
    (pkg / "traffic" / "replay_b64.json").write_text(json.dumps(traffic))
    (pkg / "kinds" / "replay.py").write_text(
        "class Cell:\n"
        "    def __init__(self, torch, cfg, traffic, spec, seed, device):\n"
        "        self.found = (cfg['model']['num_vertices'], traffic['batch'], spec['compute_dtype'], seed)\n"
    )
    spec = json.loads((pkg / "cells" / f"{tiny.TRAIN}.json").read_text())
    spec["compute_dtype"] = "float16"
    (pkg / "cells" / "flagship_n21.replay_b64.json").write_text(json.dumps(spec))
    (pkg / "metrics" / "units.train.py").write_text("def read(run):\n    return float(run.units)\n")
    bench["configs"].append(dict(bench["configs"][0], name="flagship_n21", file="portbench/configs/flagship_n21.json"))
    bench["workloads"].append({"name": "flagship_n21.replay_b64", "config": "flagship_n21",
                               "traffic": "replay_b64", "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({"name": "units.train", "unit": "steps", "better": "higher", "source": "host_clock",
                               "layer": "train loop", "moves": "train_anchors_per_s",
                               "workloads": ["flagship_n21.replay_b64"]})
    bench["end_to_end"][0]["workloads"].append("flagship_n21.replay_b64")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import sys, json, types; sys.path.insert(0, '.'); from portbench import harness;"
        "b = harness.load_json(harness.ROOT / 'BENCHMARK.json');"
        "e, c, t, s = harness.cell_files(b, 'flagship_n21.replay_b64');"
        "m = [x['name'] for x in harness.cell_metrics(b, e)[1]];"
        "r = harness.metric_reader('units.train')(types.SimpleNamespace(units=7));"
        "k = harness.make_cell(None, c, t, s, 5, 'cpu').found;"
        "print(json.dumps([m, r, k]))"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [["units.train"], 7.0, [21, 64, "float16", 5]]


FURTHER = [  # (cell, configuration, traffic): PERF.md's further cells 1 and 2
    ("packed_n32.train_b128", "packed_n32", "train_b128"),
    ("flagship_n20.codec_b64", "flagship_n20", "codec_b64"),
]


@pytest.mark.parametrize("name,config,traffic", FURTHER)
def test_further_cell_from_files_alone(tmp_path, name, config, traffic):
    """A further cell of an existing configuration and traffic mix needs a
    cell file and an entry, and no code: at a tiny size it runs and comes
    out correct."""
    root = copy_benchmark(tmp_path)
    bench = tiny.with_codec(json.loads((root / "BENCHMARK.json").read_text()))
    like = tiny.TRAIN if traffic.startswith("train") else tiny.CODEC
    spec = json.loads((root / "portbench" / "cells" / f"{like}.json").read_text())
    if traffic.startswith("train"):
        spec.update(compute_dtype="bfloat16", control="fp8", mfu_peak="bfloat16")
    else:
        spec.update(compute_dtype="float32", control="bfloat16", mfu_peak="tf32")
    (root / "portbench" / "cells" / f"{name}.json").write_text(json.dumps(spec))
    bench["workloads"].append({"name": name, "config": config, "traffic": traffic, "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if like in m.get("workloads", []):
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import sys, json, time, torch; sys.path.insert(0, '.'); from portbench import harness;"
        "from portbench.tests import tiny;"
        f"b = harness.load_json(harness.ROOT / 'BENCHMARK.json'); e, c, t, s = tiny.cell({name!r}, b);"
        "r = harness.run_cell(torch, 'cpu', b, e, c, t, s, tiny.args(), time.perf_counter());"
        "print(json.dumps([r['correct'], sorted(r['metrics']), r['checked']]))"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    correct, metrics, checked = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct, checked
    assert "setup_s" in metrics and len(metrics) >= 2


def test_a_run_imports_no_jax():
    """A run's modules, the port's included, hold no top-level name of
    JAX, its libraries or the JAX package (compared whole: the port's name
    starts with the JAX package's)."""
    code = (
        "import sys, time; sys.path.insert(0, '.'); import torch;"
        "from portbench import harness; from portbench.tests import tiny;"
        "e, c, t, s = tiny.cell(tiny.TRAIN);"
        "harness.run_cell(torch, 'cpu', tiny.BENCH, e, c, t, s, tiny.args(), time.perf_counter());"
        "import topo_audio_autoencoder_torch;"
        "print(harness.forbidden_modules(), 'topo_audio_autoencoder_torch' in sys.modules)"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlib_lookalike", sys)
    assert "jax" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "flax.core", sys)
    assert "flax" in harness.forbidden_modules()


def test_reference_imports_no_port():
    code = ("import sys; sys.path.insert(0, '.');"
            "import portbench.reference.train, portbench.reference.codec, portbench.check, portbench.counts;"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'topo_audio_autoencoder_torch', 'topo_audio_autoencoder_tpu', 'jax', 'jaxlib', 'flax', 'optax'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True, cwd=ROOT)
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("where", ["repo", "benchmark_only"])
def test_no_card_no_result(tmp_path, where):
    """Without a card (or, in a directory holding only BENCHMARK.json and
    portbench/, without the program) a run fails and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cwd = ROOT if where == "repo" else copy_benchmark(tmp_path)
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", tiny.TRAIN, "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def run_tiny(workload, trace=0):
    entry, cfg, traffic, spec = tiny.cell(workload)
    return harness.run_cell(torch, "cpu", tiny.BENCH, entry, cfg, traffic, spec, tiny.args(trace=trace),
                            time.perf_counter())


@pytest.mark.parametrize("workload", [tiny.TRAIN, tiny.CODEC])
@pytest.mark.parametrize("trace", [0, 1])
def test_sound_run_is_correct(workload, trace):
    result = run_tiny(workload, trace=trace)
    assert result["correct"], result["checked"]
    assert list(result["checked"]) == list(tiny.cell(workload)[3]["limits"])
    assert set(result) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert list(result)[-1] == "checked"
    if not trace:
        assert "setup_s" in result["metrics"]


@pytest.mark.parametrize("workload,fault", [(tiny.TRAIN, "frozen"), (tiny.TRAIN, "half_batch"),
                                            (tiny.TRAIN, "attn_dq_dropped"), (tiny.TRAIN, "attn_dkdv_dropped"),
                                            (tiny.CODEC, "altered")])
def test_fault_is_not_correct(workload, fault):
    """The timed path broken underneath: the check comes out false."""
    with faults.plant(fault):
        result = run_tiny(workload)
    assert not result["correct"], result["checked"]


@pytest.mark.parametrize("workload", [tiny.TRAIN, tiny.CODEC])
def test_control_is_not_correct(workload):
    """The reference in the cell's next lower precision, put in the
    program's place, fails the limits."""
    entry, cfg, traffic, spec = tiny.cell(workload)
    cell = harness.make_cell(torch, cfg, traffic, spec, 2**31 + 23, "cpu")
    cell.setup()
    for _ in range(traffic.get("check_among", 0)):
        cell.run()
    cell.release()
    ctl = cell.reference_readings(control=True)
    if traffic["kind"] == "train":
        numbers = check.train_numbers(ctl, cell.reference_readings())
    else:
        numbers = cell.numbers(ctl)
    correct, rows = check.judge(numbers, spec["limits"])
    assert not correct, rows


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in harness.load_json(ROOT / "BENCHMARK.json")["workloads"]])
def test_cell_on_the_card(card, workload):
    """One short run of each cell as the driver runs it."""
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", workload, "--seed", "2147483659",
                          "--seconds", "3", "--trace", "1"], cwd=ROOT, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["busy_s"] > 0
