"""The port's two examples, run on the CPU through their ``main`` at the
smallest cut: the codec round trip on a 2,048-sample clip (a clip of
1,024 samples or fewer cannot take the 2,048 STFT scale's reflect pad), at
the flagship width with fresh weights and from a checkpoint; the synthetic
training run on 8 clips for 1 epoch at the tiny width."""

import math
import sys
from pathlib import Path

import numpy as np
import torch

from topo_audio_autoencoder_torch.inference import Codec
from topo_audio_autoencoder_torch.models import AudioAutoencoder
from topo_audio_autoencoder_torch.training import CheckpointManager

torch.set_num_threads(1)

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))

import torch_codec_roundtrip  # noqa: E402
import torch_train_synthetic  # noqa: E402

T = 2048
TINY = dict(num_vertices=5, num_bands=4, sccn_hidden_dim=8, n_sccn_layers=2)


def test_codec_roundtrip_example_fresh_and_from_a_checkpoint(tmp_path, capsys):
    """Fresh weights: n=20's 6,195 bits on a 775-byte wire and a finite
    decode. From a ``best`` checkpoint and its sidecar's geometry (n=8,
    C=8, 2 layers): that model's wire, and the waveform a direct
    ``Codec`` with the checkpoint's parameters decodes, bit for bit."""
    fresh = torch_codec_roundtrip.main(["--device", "cpu"], num_samples=T)
    assert (fresh["bits"], fresh["wire_bytes"]) == (6195, 775) and fresh["finite"]
    assert "fresh (untrained) parameters" in capsys.readouterr().out

    geometry = dict(num_vertices=8, sccn_hidden_dim=8, n_sccn_layers=2, max_active_vertices=8)
    model = AudioAutoencoder.create(**geometry, num_samples=T, device="cpu", seed=3)
    CheckpointManager(tmp_path).save("best", {"params": model.state_dict()}, extra={"model": model.geometry()})
    got = torch_codec_roundtrip.main([str(tmp_path), "--packed", "--device", "cpu"], num_samples=T)
    bits = sum(math.comb(8, k) for k in range(1, 5))
    assert (got["bits"], got["wire_bytes"]) == (bits, math.ceil(bits / 8)) and got["finite"]
    assert "loaded 'best'" in capsys.readouterr().out
    codec = Codec(model, device="cpu")
    from topo_audio_autoencoder_torch.data import synth_corpus

    x = torch.from_numpy(synth_corpus(1, n_samples=T, seed=7))[:, None, :]
    latent = codec.encode(x)
    assert torch.equal(got["waveform"], codec.decode(latent, T))


def test_train_synthetic_example_runs_one_epoch(tmp_path, monkeypatch):
    """8 clips, 1 epoch, bf16, accumulation 1, at the tiny width (B=4):
    finite losses, and the checkpoints under ./checkpoints_synthetic_torch."""
    monkeypatch.chdir(tmp_path)
    metrics = torch_train_synthetic.main(["8", "1", "--device", "cpu"], num_samples=T, model_config=TINY,
                                         batch_size=4)
    assert len(metrics.train_losses) == 1 and np.isfinite(metrics.train_losses + metrics.val_losses).all()
    assert metrics.best_epoch == 0 and np.isfinite(metrics.best_val_loss)
    ckpt = tmp_path / "checkpoints_synthetic_torch"
    assert (ckpt / "best" / "state.pt").exists() and (ckpt / "best.extra.json").exists()
