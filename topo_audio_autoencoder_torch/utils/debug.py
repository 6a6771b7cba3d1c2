"""Debug instrumentation: NaN/Inf detection, scoped and opt-in.

Port of ``topo_audio_autoencoder_tpu.utils.debug``. The reference enables
``torch.autograd.set_detect_anomaly(True)`` globally at import time
(SURVEY §5.2), and anomaly mode checks only the backward. Here detection
is scoped: a ``TorchDispatchMode`` checks the floating outputs of every op
that runs under it, forward and backward alike, and raises on the first
NaN or Inf (``FloatingPointError``, as ``jax_debug_nans`` does); anomaly
mode is on beside it, so a failing backward also names the forward op
that recorded it.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

# Ops whose output is uninitialized memory: never checked.
_UNINITIALIZED = {
    aten.empty.memory_format,
    aten.empty_like.default,
    aten.empty_strided.default,
    aten.new_empty.default,
    aten.new_empty_strided.default,
}
# Ops that index with a tensor: (position of the indexed tensor, of the dim
# (None: the indices list's position gives it), of the index; whether
# negative indices wrap).
_INDEXING = {
    aten.gather.default: (0, 1, 2, False),
    aten.index_select.default: (0, 1, 2, False),
    aten.scatter.src: (0, 1, 2, False),
    aten.scatter.value: (0, 1, 2, False),
    aten.scatter_add.default: (0, 1, 2, False),
    aten.scatter_reduce.two: (0, 1, 2, False),
    aten.index_add.default: (0, 1, 2, False),
    aten.embedding.default: (0, None, 1, False),
    aten.index.Tensor: (0, None, 1, True),
    aten.index_put.default: (0, None, 1, True),
    aten.index_put_.default: (0, None, 1, True),
}
_INT_DIVISION = {aten.div.Tensor, aten.div.Tensor_mode, aten.floor_divide.default, aten.remainder.Tensor,
                 aten.fmod.Tensor}
ALL_CHECKS = frozenset({"nan", "inf", "index", "div"})


def _check_indices(func, args) -> None:
    src_pos, dim_pos, idx_pos, wraps = _INDEXING[func]
    src, idx = args[src_pos], args[idx_pos]
    if func is aten.embedding.default:
        pairs = [(0, idx)]
    elif dim_pos is None:  # a list of optional index tensors, one per dim
        pairs = [(d, i) for d, i in enumerate(idx) if i is not None and i.dtype != torch.bool]
    else:
        pairs = [(args[dim_pos] % max(src.dim(), 1), idx)]
    for d, i in pairs:
        n = src.shape[d] if src.dim() else 1
        if i.numel() == 0:
            continue
        lo = -n if wraps else 0
        if bool((i < lo).any()) or bool((i >= n).any()):
            raise IndexError(
                f"out-of-bounds indexing in {func}: an index of dimension {d} lies outside [{lo}, {n})"
            )


def _check_division(args) -> None:
    den = args[1]
    if isinstance(den, torch.Tensor) and not den.is_floating_point() and not den.is_complex():
        if bool((den == 0).any()):
            raise ZeroDivisionError("integer division by zero")
    elif isinstance(den, int) and den == 0:
        raise ZeroDivisionError("integer division by zero")


class _Checks(TorchDispatchMode):
    """Checks every op that runs under it: index tensors against their
    bounds and integer divisors against zero before the op, floating
    outputs for NaN and Inf after it."""

    def __init__(self, checks: frozenset):
        super().__init__()
        self.checks = checks

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if "index" in self.checks and func in _INDEXING:
            _check_indices(func, args)
        if "div" in self.checks and func in _INT_DIVISION and isinstance(args[0], torch.Tensor) and not (
            args[0].is_floating_point() or args[0].is_complex()
        ):
            _check_division(args)
        out = func(*args, **kwargs)
        if func not in _UNINITIALIZED:
            for t in pytree.tree_leaves(out):
                if not isinstance(t, torch.Tensor) or not (t.is_floating_point() or t.is_complex()):
                    continue
                if "nan" in self.checks and bool(torch.isnan(t).any()):
                    raise FloatingPointError(f"invalid value (nan) encountered in {func}")
                if "inf" in self.checks and bool(torch.isinf(t).any()):
                    raise FloatingPointError(f"invalid value (inf) encountered in {func}")
        return out


@contextlib.contextmanager
def _scoped(checks: frozenset):
    """The checks and anomaly mode (its NaN check with "nan") inside the
    scope; the previous anomaly mode restored on exit."""
    previous = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    torch.autograd.set_detect_anomaly(bool(checks), check_nan="nan" in checks)
    try:
        with _Checks(checks):
            yield
    finally:
        torch.autograd.set_detect_anomaly(*previous)


@contextlib.contextmanager
def detect_anomalies(nans: bool = True, infs: bool = True):
    """Scoped NaN/Inf detection, the analog of jax_debug_nans/jax_debug_infs:
    the first op inside the scope (forward or backward) whose floating
    output holds a NaN (``nans``) or an Inf (``infs``) raises
    ``FloatingPointError``. Anomaly mode is on inside the scope and restored
    on exit. Every op synchronises with the device: debug only."""
    with _scoped(frozenset(c for c, on in (("nan", nans), ("inf", infs)) if on)):
        yield


def assert_finite_tree(tree, name: str = "tree") -> None:
    """Host-side finiteness check over nested dicts, lists and tuples of
    tensors or arrays; the error names the leaf's path."""

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}[{k!r}]")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}[{i}]")
        else:
            arr = node.detach().cpu().numpy() if isinstance(node, torch.Tensor) else np.asarray(node)
            if not np.all(np.isfinite(arr)):
                raise FloatingPointError(f"non-finite values in {name}:{path}")

    walk(tree, "")


def finite_or_zero(x: torch.Tensor) -> torch.Tensor:
    """Replace non-finite entries with zero (guarded reductions)."""
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def checked(fn, *, errors=None):
    """Wrap ``fn`` with runtime checks, the replacement for JAX's
    ``checkify`` (SURVEY §5.2: the reference keeps autograd's anomaly mode
    always on). Returns a function that raises on the first triggered
    check. ``errors`` is a subset of ``ALL_CHECKS`` (the default):

    - "nan", "inf": the floating outputs of every op (``FloatingPointError``);
      a backward run inside ``fn`` is checked too, under anomaly mode;
    - "index": the index tensor of every gather, scatter, index,
      index_put, index_select, index_add and embedding op against the
      bounds of the dimension it indexes (``IndexError``), before the op
      runs (on the card an out-of-bounds index is a device fault, not an
      error);
    - "div": integer divisors against zero (``ZeroDivisionError``).

    Not checked: the arithmetic inside one op (only its outputs are seen),
    the port's CUDA kernels (launched through ctypes, past the dispatcher:
    a NaN they write is caught at the first op that reads it), integer
    overflow, and tensors an op leaves uninitialized (``empty``).

    Usage: ``checked(train_step)(state, batch, ...)``. Every op
    synchronises with the device: debug only.
    """
    checks = ALL_CHECKS if errors is None else frozenset(errors)
    if not checks <= ALL_CHECKS:
        raise ValueError(f"unknown checks {sorted(checks - ALL_CHECKS)}; choose from {sorted(ALL_CHECKS)}")

    def wrapper(*args, **kwargs):
        with _scoped(checks):
            return fn(*args, **kwargs)

    return wrapper


@contextlib.contextmanager
def golden_precision():
    """Pin full fp32 matmul and convolution precision (no TF32) for
    card-vs-CPU golden comparisons; the previous settings are restored."""
    old = (
        torch.get_float32_matmul_precision(),
        torch.backends.cuda.matmul.allow_tf32,
        torch.backends.cudnn.allow_tf32,
    )
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old[0])
        torch.backends.cuda.matmul.allow_tf32 = old[1]
        torch.backends.cudnn.allow_tf32 = old[2]
