"""Single dataclass-tree configuration with CLI overrides.

Port of ``topo_audio_autoencoder_tpu.config``: the same dataclasses,
defaults and ``section.key=value`` overrides (e.g. ``train.batch_size=32``),
so one command line means the same run in either package. One field is the
port's own: ``train.device``, where the run goes. ``None`` (the default)
means the CUDA card, and raises without one; ``train.device=cpu`` runs the
plain PyTorch path on the CPU, as ``device=`` does at every other entry
point of the port.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass
class DataConfig:
    """Corpus + preprocessing (main.py:18-23)."""

    data_path: str = "./nsynth"
    output_dir: str = "./AudioTensors"
    precomputed_path: str = "./precomputed/distances.npz"
    num_train_samples: int = 1024
    val_ratio: float = 0.2
    sample_rate: int = 16000
    clip_samples: int = 64000


@dataclass
class ModelConfig:
    """Model hyperparameters (main.py:272-278)."""

    num_vertices: int = 20
    num_bands: int = 16
    sccn_hidden_dim: int = 64
    min_active_vertices: int = 8
    max_active_vertices: int = 20
    hard: bool = False
    sampler: str = "gumbel"  # or "hard_concrete"
    learned_hc: bool = False  # learn per-rank beta/gamma/zeta (hard_concrete)
    dropout: float = 0.1
    n_sccn_layers: int = 6
    pqmf_attenuation: float = 100.0
    # Static-capacity packed operators (topology/packed.py): per-rank
    # top-K capacities, e.g. (0, 0, 512, 256) packs triangles/tetra at
    # n=32 (0 = keep that rank dense). None = fully dense masked-static.
    pack_capacities: tuple | None = None


@dataclass
class TrainConfig:
    """Trainer knobs (trainer.py:50-72, main.py:291-304)."""

    checkpoint_dir: str = "./checkpoints"
    encoder_lr: float = 1e-3
    decoder_lr: float = 1e-4
    batch_size: int = 4
    accumulate_grad_batches: int = 4
    gradient_clip_val: float = 10.0
    max_epochs: int = 100
    patience: int = 20
    tuning_epochs: int = 5
    initial_temp: float = 5.0
    min_temp: float = 0.1
    temp_decay: float = 0.95
    initial_reg_factor: float = 1e-5
    complexity_penalty: float = 0.1
    l0_penalty: float = 0.0  # Hard Concrete expected-L0 sparsity weight
    invalid_state_penalty: float = 100.0
    seed: int = 511990
    compute_dtype: str = "float32"
    n_devices: int | None = None  # data-parallel width (> 1 is not ported yet)
    # Resume from <checkpoint_dir>/latest: skips the checkpoint-dir
    # rotation and restores params/opt-state/metrics/curriculum/RNG
    # (the reference always rotates, main.py:240-256; resume is a rebuild
    # addition — see Trainer.train(resume=True)).
    resume: bool = False
    # Run the epoch in segments of this many steps (device-corpus path;
    # 0/1 = one step at a time). See TrainerConfig.scan_steps.
    scan_steps: int = 0
    # End-of-epoch checkpoints on a background thread (device-side state
    # snapshot; see TrainerConfig.async_checkpoint).
    async_checkpoint: bool = True
    # Where the run goes: None = the CUDA card, "cpu" = the plain path.
    device: str | None = None


@dataclass
class TuningGrid:
    """Grid-search space (main.py:261-265)."""

    encoder_lr: list = field(default_factory=lambda: [1e-3, 5e-4])
    decoder_lr: list = field(default_factory=lambda: [1e-4, 5e-5])
    complexity_penalty: list = field(default_factory=lambda: [0.05, 0.1])


@dataclass
class ExploreConfig:
    """Neighbor exploration (reference main.py:88-176,285-288) — the
    reference gates it behind an interactive input() prompt; here it is a
    config switch (``explore.enabled=true``) that dumps a sample's
    nearest/farthest neighbors as wavs before training starts."""

    enabled: bool = False
    index: int | None = None  # clip to explore; None = seeded random
    num_neighbors: int = 3
    out_dir: str = "./neighbor_samples"


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    grid: TuningGrid = field(default_factory=TuningGrid)
    explore: ExploreConfig = field(default_factory=ExploreConfig)
    run_tuning: bool = True

    @classmethod
    def from_args(cls, args: list[str]) -> "Config":
        """Apply dotted ``section.key=value`` overrides."""
        cfg = cls()
        for arg in args:
            if "=" not in arg:
                raise ValueError(f"override must be key=value, got {arg!r}")
            path, value = arg.split("=", 1)
            parts = path.split(".")
            obj = cfg
            for p in parts[:-1]:
                obj = getattr(obj, p)
            key = parts[-1]
            current = getattr(obj, key)
            setattr(obj, key, _coerce(value, current, _declared(obj, key)))
        return cfg

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _declared(obj, key: str) -> str:
    """The declared type of dataclass field ``key``, as written."""
    return str(next(f.type for f in dataclasses.fields(obj) if f.name == key))


def _coerce(value: str, current, declared: str = ""):
    if isinstance(current, bool):
        return value.lower() in ("1", "true", "yes")
    if isinstance(current, int):
        return int(value)
    if isinstance(current, float):
        return float(value)
    if isinstance(current, list):
        return [
            _coerce(v, current[0] if current else 0.0) for v in value.split(",")
        ]
    if current is None:
        if value.lower() == "none":
            return None
        # An optional string (train.device) keeps the text; the JAX
        # package's optional fields are all integers.
        return value if declared.startswith("str") else int(value)
    return value
