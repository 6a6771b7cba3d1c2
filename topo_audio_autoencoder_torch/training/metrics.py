"""Training metrics: JSON-persisted curves + best-run bookkeeping.

Port of ``topo_audio_autoencoder_tpu.training.metrics``, with the same
files and keys: ``metrics.json`` (train/val loss curves, per-iteration
losses, best loss/epoch/hyperparameters, the held-out test loss) and the
JSON-lines stream ``train_log.jsonl`` (one record per logged step: the loss
components and the per-component gradient norms). Values may be Python
numbers, numpy scalars or 0-d tensors; each is written as a float.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from pathlib import Path


@dataclass
class TrainingMetrics:
    train_losses: list = field(default_factory=list)
    val_losses: list = field(default_factory=list)
    iteration_losses: list = field(default_factory=list)
    best_val_loss: float = float("inf")
    best_epoch: int = -1
    best_params: dict | None = None
    test_loss: float | None = None  # held-out set, scored once after training

    def save(self, directory: str | Path) -> None:
        path = Path(directory) / "metrics.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(asdict(self), indent=2))

    @classmethod
    def load(cls, directory: str | Path) -> "TrainingMetrics":
        path = Path(directory) / "metrics.json"
        if not path.exists():
            return cls()
        data = json.loads(path.read_text())
        return cls(**data)


class MetricWriter:
    """Append-only JSON-lines metric stream (one dict per step)."""

    def __init__(self, directory: str | Path, name: str = "train_log"):
        self.path = Path(directory) / f"{name}.jsonl"
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def write(self, step: int, payload: dict) -> None:
        record = {"step": int(step)}
        for k, v in payload.items():
            if isinstance(v, dict):
                record[k] = {kk: float(vv) for kk, vv in v.items()}
            else:
                record[k] = float(v)
        with self.path.open("a") as f:
            f.write(json.dumps(record) + "\n")
