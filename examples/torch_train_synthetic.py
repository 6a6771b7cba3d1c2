"""End-to-end demo on the PyTorch port: train the topological audio
autoencoder on a synthetic NSynth-like corpus (no dataset download).

    python examples/torch_train_synthetic.py [n_clips] [epochs] [--device cpu]

Covers the full pipeline: corpus synthesis -> the O(N^2) spectral
distance precompute on the device -> the contrastive curriculum dataset ->
bf16 training with the device-resident corpus -> eval, checkpoints (in
``./checkpoints_synthetic_torch``) and audio dumps. Runs on the CUDA card
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

from topo_audio_autoencoder_torch.data import NSynthDataset, compute_distances, synth_corpus
from topo_audio_autoencoder_torch.models import AudioAutoencoder
from topo_audio_autoencoder_torch.training import Trainer, TrainerConfig

NUM_SAMPLES = 64000
FLAGSHIP = dict(num_vertices=20, num_bands=16, sccn_hidden_dim=64)


def main(argv=None, num_samples: int = NUM_SAMPLES, model_config: dict | None = None, batch_size: int = 16):
    """Runs the demo and returns the ``TrainingMetrics``. ``num_samples``,
    ``model_config`` (``AudioAutoencoder.create``'s geometry) and
    ``batch_size`` cut it in size."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("n_clips", nargs="?", type=int, default=64)
    parser.add_argument("epochs", nargs="?", type=int, default=20)
    parser.add_argument("--device", default=None, help="cpu, or a CUDA device (default: the card)")
    args = parser.parse_args(argv)
    n = args.n_clips

    print(f"synthesizing {n} clips...")
    corpus = synth_corpus(n, num_samples)
    print("precomputing pairwise spectral distances on device...")
    dists = compute_distances(corpus, tile=32, device=args.device)
    train = NSynthDataset(corpus, dists["neighbors"], train=True)
    val = NSynthDataset(synth_corpus(max(8, n // 8), num_samples, seed=7), train=False)

    model = AudioAutoencoder.create(**(model_config or FLAGSHIP), num_samples=num_samples, device=args.device)
    trainer = Trainer(
        model,
        train,
        val,
        config=TrainerConfig(
            checkpoint_dir="./checkpoints_synthetic_torch",
            batch_size=batch_size,
            accumulate_grad_batches=1,
            max_epochs=args.epochs,
            compute_dtype="bfloat16",
            log_every=10,
            checkpoint_every_iters=0,
            device=args.device,
        ),
    )
    metrics = trainer.train()
    print(f"train: {metrics.train_losses[0]:.3f} -> {metrics.train_losses[-1]:.3f}")
    print(f"best val {metrics.best_val_loss:.3f} @ epoch {metrics.best_epoch}")
    return metrics


if __name__ == "__main__":
    main()
