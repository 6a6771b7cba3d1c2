"""Checkpoints: params, optimizer state, step, and a JSON sidecar.

Port of ``topo_audio_autoencoder_tpu.training.checkpoint`` with
``torch.save`` / ``torch.load(weights_only=True)`` in place of Orbax, and
the same layout and guarantees:

- ``<dir>/<name>/state.pt`` holds the state: a nested dict of tensors and
  Python numbers, copied to the CPU (nothing that needs pickled classes,
  so that ``weights_only=True`` loads it);
- the sidecar of host metadata sits *next to* it, as
  ``<dir>/<name>.extra.json``; an older in-dir ``extra.json`` is still read;
- an overwrite is crash-safe: the new state is committed to
  ``<name>.swap`` (its ``state.pt`` written under a temporary name and
  renamed) and only then renamed over the old one, so every crash window
  leaves either the old checkpoint or a complete ``.swap``, which
  ``restore``/``exists`` fall back to.

Cadence decisions stay in the trainer; so does the asynchronous save.
"""

from __future__ import annotations

import json
import shutil
from collections.abc import Mapping
from pathlib import Path
from typing import Any

import numpy as np
import torch

STATE_FILE = "state.pt"


def to_host(tree: Any) -> Any:
    """Every tensor of a nested dict on the CPU, numpy arrays as tensors;
    numbers unchanged."""
    if isinstance(tree, Mapping):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(tree))
    if isinstance(tree, np.generic):
        return tree.item()
    return tree


def cast_like(tree: Any, template: Any, path: str = "") -> Any:
    """``tree`` with each tensor cast to the dtype and device of the tensor
    at the same place in ``template``; raises where the keys differ."""
    if isinstance(template, Mapping):
        if not isinstance(tree, Mapping) or set(tree) != set(template):
            raise KeyError(f"checkpoint entry {path or '/'} does not match the template's keys")
        return {k: cast_like(tree[k], template[k], f"{path}/{k}") for k in template}
    if isinstance(template, torch.Tensor):
        if tuple(tree.shape) != tuple(template.shape):
            raise ValueError(f"checkpoint entry {path}: shape {tuple(tree.shape)}, template {tuple(template.shape)}")
        return tree.to(dtype=template.dtype, device=template.device)
    return tree


class CheckpointManager:
    """Checkpoints keyed by name under one directory. Saves are synchronous
    here; the trainer runs a whole save on a background thread against a
    device-side snapshot when it asks for an asynchronous one."""

    def __init__(self, directory: str | Path):
        self.directory = Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)

    def _path(self, name: str) -> Path:
        return self.directory / name

    def _swap_path(self, name: str) -> Path:
        return self.directory / f"{name}.swap"

    def _extra_path(self, name: str) -> Path:
        return self.directory / f"{name}.extra.json"

    def save(self, name: str, state: Any, extra: dict | None = None) -> None:
        """Save a nested dict of tensors and numbers (+ a small JSON sidecar
        of host metadata), crash-safe as the module docstring says."""
        path = self._path(name)
        swap = self._swap_path(name)
        if swap.exists():
            shutil.rmtree(swap)
        swap.mkdir(parents=True)
        partial = swap / (STATE_FILE + ".tmp")
        torch.save(to_host(state), partial)
        partial.rename(swap / STATE_FILE)
        if path.exists():
            shutil.rmtree(path)
        swap.rename(path)
        if extra is not None:
            self._extra_path(name).write_text(json.dumps(extra))

    def _resolve(self, name: str) -> Path:
        """The final dir, or a complete ``.swap`` left by a crash between
        the old checkpoint's removal and the swap rename."""
        path = self._path(name)
        swap = self._swap_path(name)
        if not path.exists() and (swap / STATE_FILE).exists():
            return swap
        return path

    def restore(self, name: str, template: Any = None) -> Any:
        """Restore by name, on the CPU; with ``template`` (a nested dict of
        tensors) each tensor takes the template's dtype and device."""
        state = torch.load(self._resolve(name) / STATE_FILE, map_location="cpu", weights_only=True)
        return state if template is None else cast_like(state, template)

    def load_extra(self, name: str) -> dict | None:
        p = self._extra_path(name)
        if not p.exists():  # legacy layout: sidecar inside the dir
            p = self._path(name) / "extra.json"
        return json.loads(p.read_text()) if p.exists() else None

    def exists(self, name: str) -> bool:
        return self._resolve(name).exists()

    def latest_epoch_name(self, prefix: str = "epoch_") -> str | None:
        """Most recent ``epoch_N`` checkpoint (per-combo resume during
        tuning). Names are visited in sorted order, so of two names with the
        same N (``epoch_N`` and ``epoch_N_iter_I``) the first in that order
        wins on every filesystem."""
        best_n, best = -1, None
        for p in sorted(self.directory.glob(f"{prefix}*")):
            if not p.is_dir():  # skip .extra.json sidecars
                continue
            try:
                n = int(p.name.split("_")[1])
            except (IndexError, ValueError):
                continue
            if n > best_n:
                best_n, best = n, p.name
        return best
