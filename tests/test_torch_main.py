"""The port's configuration and ``main`` on tiny CLI arguments on the CPU:
the JAX package's overrides give the same configuration, and one command
line runs tuning, training, directory rotation and resume end to end
(as tests/test_main.py runs the JAX package's)."""

import json

import numpy as np
import pytest
import torch

from topo_audio_autoencoder_torch.config import Config
from topo_audio_autoencoder_torch.main import main
from topo_audio_autoencoder_tpu.config import Config as JaxConfig

torch.set_num_threads(1)

OVERRIDES = [
    [],
    ["model.num_vertices=12", "train.batch_size=32", "model.hard=true", "run_tuning=false",
     "grid.encoder_lr=0.01,0.001", "train.compute_dtype=bfloat16"],
    ["train.n_devices=2", "explore.index=3", "data.val_ratio=0.25",
     "train.resume=yes", "train.scan_steps=4", "grid.complexity_penalty=0.5", "model.sampler=hard_concrete"],
]


@pytest.mark.parametrize("args", OVERRIDES)
def test_config_matches_jax(args):
    """Config.from_args gives the JAX package's to_dict(), less the port's
    own train.device, with or without it on the command line."""
    want = JaxConfig.from_args(args).to_dict()
    for device in ([], ["train.device=cpu"]):
        got = Config.from_args(args + device).to_dict()
        assert got["train"].pop("device") == ("cpu" if device else None)
        assert got == want


def test_config_device_override():
    assert Config().train.device is None
    assert Config.from_args(["train.device=cpu"]).train.device == "cpu"
    assert Config.from_args(["train.device=none"]).train.device is None
    assert Config.from_args(["train.device=cuda:1"]).train.device == "cuda:1"
    with pytest.raises(ValueError):
        Config.from_args(["train.device"])


def _args(tmp_path, **over):
    base = {
        "data.data_path": str(tmp_path / "nodata"),  # forces the synthetic corpus
        "data.output_dir": str(tmp_path / "out"),
        "data.precomputed_path": str(tmp_path / "pre" / "d.npz"),
        "data.num_train_samples": "6",
        "data.clip_samples": "4096",
        "train.checkpoint_dir": str(tmp_path / "ckpt"),
        "train.batch_size": "2",
        "train.max_epochs": "2",
        "train.accumulate_grad_batches": "1",
        "train.device": "cpu",
        "model.num_vertices": "6",
        "model.num_bands": "4",
        "model.sccn_hidden_dim": "16",
        "model.n_sccn_layers": "1",
        "run_tuning": "false",
    }
    base.update(over)
    return [f"{k}={v}" for k, v in base.items()]


TUNING = {
    "run_tuning": "true",
    "train.tuning_epochs": "1",
    "grid.encoder_lr": "0.001",
    "grid.decoder_lr": "0.0001,0.00005",
    "grid.complexity_penalty": "0.1",
}


def test_main_end_to_end_and_cli_resume(tmp_path, capsys):
    """Tuning + 2 epochs, the checkpoint layout and its sidecars; a second
    run rotates the directory away; train.resume=true keeps it and runs
    exactly one more epoch, its first two epochs as they were."""
    main(_args(tmp_path, **TUNING))
    ckpt = tmp_path / "ckpt"
    metrics = json.loads((ckpt / "metrics.json").read_text())
    assert len(metrics["train_losses"]) == 2 and np.all(np.isfinite(metrics["iteration_losses"]))
    assert metrics["best_params"]["decoder_lr"] in (1e-4, 5e-5)
    for name in ("best", "latest", "epoch_0", "best_tuning", "e0.001_d0.0001_c0.1/epoch_0",
                 "e0.001_d5e-05_c0.1/epoch_0"):
        assert (ckpt / name / "state.pt").exists(), name
    latest = json.loads((ckpt / "latest.extra.json").read_text())
    assert set(latest) == {"encoder_lr", "decoder_lr", "complexity_penalty", "model", "train_state"}
    assert set(latest["train_state"]) == {"epoch", "metrics", "dataset_epoch", "rng_key"}
    assert latest["model"]["vertices"] == 6 and latest["train_state"]["epoch"] == 1
    log = [json.loads(x) for x in (ckpt / "train_log.jsonl").read_text().splitlines()]
    assert all("grad_norms" in r and np.isfinite(r["total_loss"]) for r in log)
    dump = ckpt / "samples" / "epoch_0_iter_0"
    assert sorted(p.name for p in dump.iterdir()) == ["input_0.wav", "metadata_0.json", "output_0.wav"]
    assert set(json.loads((dump / "metadata_0.json").read_text())["complex_data"]) == {
        "num_vertices", "num_edges", "num_triangles", "num_tetra"}
    assert "best val loss" in capsys.readouterr().out

    # Without resume the run directory rotates away.
    main(_args(tmp_path))
    assert (tmp_path / "ckpt_old" / "best_tuning").exists()
    m2 = json.loads((ckpt / "metrics.json").read_text())
    assert len(m2["train_losses"]) == 2 and not (ckpt / "best_tuning").exists()

    # With train.resume=true the directory stays and training continues
    # from the restored epoch counter.
    main(_args(tmp_path, **{"train.max_epochs": "3", "train.resume": "true"}))
    m3 = json.loads((ckpt / "metrics.json").read_text())
    assert len(m3["train_losses"]) == 3
    assert m3["train_losses"][:2] == m2["train_losses"]
    assert (ckpt / "epoch_0").exists() and not (tmp_path / "ckpt_old_old").exists()


def test_main_scan_steps_and_explore_cli(tmp_path):
    """train.scan_steps=2 routes the epoch through the scanned segments;
    explore.enabled=true dumps a sample's nearest and farthest neighbors
    before training."""
    out = tmp_path / "neigh"
    main(_args(tmp_path, **{
        "train.scan_steps": "2",
        "explore.enabled": "true",
        "explore.index": "2",
        "explore.num_neighbors": "2",
        "explore.out_dir": str(out),
    }))
    metrics = json.loads((tmp_path / "ckpt" / "metrics.json").read_text())
    assert len(metrics["train_losses"]) == 2 and np.all(np.isfinite(metrics["train_losses"]))
    d = out / "2"
    assert (d / "original.wav").exists()
    assert len(list((d / "nearest").glob("neighbor_*.wav"))) == 2
    assert len(list((d / "farthest").glob("neighbor_*.wav"))) == 2


def test_main_needs_a_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(_args(tmp_path, **{"train.device": "none"}))
