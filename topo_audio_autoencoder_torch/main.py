"""Entry point: preprocess -> distance precompute -> train.

Port of ``topo_audio_autoencoder_tpu.main``: the same steps and the same
``section.key=value`` overrides. The run goes to the CUDA card (the model,
the distance precompute, the trainer) unless ``train.device=cpu`` asks for
the plain path on the CPU.

Usage:
    python -m topo_audio_autoencoder_torch.main [overrides...]
    python -m topo_audio_autoencoder_torch.main data.data_path=/data/nsynth \
        train.batch_size=32 model.hard=true run_tuning=false
    python -m topo_audio_autoencoder_torch.main train.device=cpu ...
    python -m topo_audio_autoencoder_torch.main train.resume=true ...
"""

from __future__ import annotations

import shutil
import sys
from pathlib import Path

import numpy as np

from .config import Config
from .data import (
    NSynthDataset,
    compute_distances,
    load_distances,
    preprocess_split,
    synth_corpus,
)
from .models import AudioAutoencoder
from .training import Trainer, TrainerConfig


def setup_checkpoint_dir(path: str) -> Path:
    """Rotate ./checkpoints -> ./checkpoints_old (an empty or new dir stays)."""
    d = Path(path)
    if d.exists() and any(d.iterdir()):
        old = d.with_name(d.name + "_old")
        if old.exists():
            shutil.rmtree(old)
        d.rename(old)
    d.mkdir(parents=True, exist_ok=True)
    return d


def prepare_data(cfg: Config):
    """Preprocess wavs (or synthesize a corpus) + precompute distances."""
    data_dir = Path(cfg.data.data_path)
    out = Path(cfg.data.output_dir)
    n = cfg.data.num_train_samples

    wavs = sorted(data_dir.glob("**/*.wav")) if data_dir.exists() else []
    if wavs:
        wavs = wavs[: int(n * (1 + cfg.data.val_ratio))]
        corpus = preprocess_split(
            wavs, out, "all", cfg.data.sample_rate, cfg.data.clip_samples
        )
    else:
        print(f"no wavs under {data_dir}; using a synthetic corpus")
        corpus = synth_corpus(
            int(n * (1 + cfg.data.val_ratio)), cfg.data.clip_samples
        )

    n_train = min(n, int(len(corpus) / (1 + cfg.data.val_ratio)))
    train_wavs = corpus[:n_train]
    val_wavs = corpus[n_train:]

    pre = Path(cfg.data.precomputed_path)
    if pre.exists():
        dists = load_distances(pre)
    else:
        dists = compute_distances(train_wavs, save_path=pre, device=cfg.train.device)

    train_ds = NSynthDataset(
        train_wavs, dists["neighbors"], train=True, seed=cfg.train.seed
    )
    val_ds = NSynthDataset(val_wavs, train=False)
    return train_ds, val_ds, dists


def main(argv: list[str] | None = None) -> None:
    cfg = Config.from_args(argv if argv is not None else sys.argv[1:])
    if cfg.train.resume:
        # train.resume=true: keep the existing run directory intact and
        # pick up from its 'latest' checkpoint instead of rotating it away.
        checkpoint_dir = Path(cfg.train.checkpoint_dir)
        checkpoint_dir.mkdir(parents=True, exist_ok=True)
    else:
        checkpoint_dir = setup_checkpoint_dir(cfg.train.checkpoint_dir)

    model = AudioAutoencoder.create(
        num_vertices=cfg.model.num_vertices,
        num_bands=cfg.model.num_bands,
        sccn_hidden_dim=cfg.model.sccn_hidden_dim,
        min_active_vertices=cfg.model.min_active_vertices,
        max_active_vertices=cfg.model.max_active_vertices,
        hard=cfg.model.hard,
        sampler=cfg.model.sampler,
        learned_hc=cfg.model.learned_hc,
        dropout=cfg.model.dropout,
        n_sccn_layers=cfg.model.n_sccn_layers,
        pqmf_attenuation=cfg.model.pqmf_attenuation,
        pack_capacities=cfg.model.pack_capacities,
        num_samples=cfg.data.clip_samples,
        device=cfg.train.device,
    )
    train_ds, val_ds, dists = prepare_data(cfg)

    if cfg.explore.enabled:
        # Config-gated and non-interactive: dump a sample's nearest and
        # farthest neighbors before training.
        from .data import explore_neighbors

        d = explore_neighbors(
            np.asarray(train_ds.waveforms),
            dists["distances"],
            dists["neighbors"],
            index=cfg.explore.index,
            out_dir=cfg.explore.out_dir,
            num_neighbors=cfg.explore.num_neighbors,
            sample_rate=cfg.data.sample_rate,
            seed=cfg.train.seed,
        )
        print(f"neighbor exploration written to {d}")

    t = cfg.train
    trainer = Trainer(
        model,
        train_ds,
        val_ds,
        config=TrainerConfig(
            checkpoint_dir=str(checkpoint_dir),
            encoder_lr=t.encoder_lr,
            decoder_lr=t.decoder_lr,
            batch_size=t.batch_size,
            initial_reg_factor=t.initial_reg_factor,
            complexity_penalty=t.complexity_penalty,
            l0_penalty=t.l0_penalty,
            invalid_state_penalty=t.invalid_state_penalty,
            seed=t.seed,
            initial_temp=t.initial_temp,
            min_temp=t.min_temp,
            temp_decay=t.temp_decay,
            gradient_clip_val=t.gradient_clip_val,
            accumulate_grad_batches=t.accumulate_grad_batches,
            max_epochs=t.max_epochs,
            patience=t.patience,
            tuning_epochs=t.tuning_epochs,
            compute_dtype=t.compute_dtype,
            data_parallel=t.n_devices is not None and t.n_devices > 1,
            n_devices=t.n_devices,
            scan_steps=t.scan_steps,
            async_checkpoint=t.async_checkpoint,
            device=t.device,
        ),
    )
    grid = (
        {
            "encoder_lr": cfg.grid.encoder_lr,
            "decoder_lr": cfg.grid.decoder_lr,
            "complexity_penalty": cfg.grid.complexity_penalty,
        }
        if cfg.run_tuning
        else None
    )
    metrics = trainer.train(grid, resume=cfg.train.resume)
    print(f"best val loss {metrics.best_val_loss:.4f} @ epoch {metrics.best_epoch}")


if __name__ == "__main__":
    main()
