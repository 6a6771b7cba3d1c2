"""The comparison that decides ``correct``: the numbers read from the
program's answers against the plain reference's, each beside its limit.

Train cells compare the first steps' readings by the worst leaf: the gap
between two norms, not the norm of a difference, over the reference's
norm of that leaf or of the median leaf, whichever is larger. Leaves whose
first reference gradient is under ``TINY_GRAD`` of the median leaf's move
under Adam by round-off alone and are left out of the change. The
``*_large`` numbers take only leaves of at least ``LARGE_LEAF`` elements
(the kernels and mixes; not the scalar, bias, scale and [C, 1] leaves,
whose single Adam step flips sign under rounding), with the median over
those leaves.

Codec cells compare the wire's bits (root flips: a simplex whose bit
differs while every face's bit agrees, so one flipped logit counts once
and not with every coface it closes) and the waveform the program decoded
against the reference's decode of the same bits (relative L2 of the worst
clip).
"""

from __future__ import annotations

import statistics

import numpy as np

TINY_GRAD = 1e-3
LARGE_LEAF = 1024


def leaf_norms(tensors: dict) -> dict:
    """The L2 norm of each tensor, as floats."""
    return {n: float(t.detach().float().norm()) for n, t in tensors.items()}


def _leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    names = [n for n in ref if keep is None or keep(n)]
    median = statistics.median(ref[n] for n in names)
    return {n: abs(prog[n] - ref[n]) / max(ref[n], median, 1e-30) for n in names}


def _rel(p: float, r: float) -> float:
    return abs(p - r) / max(abs(r), 1e-30)


def _worst(gaps: dict) -> tuple:
    if not gaps:
        return float("nan"), None
    name = max(gaps, key=gaps.get)
    return gaps[name], name


def train_numbers(prog: dict, ref: dict) -> dict:
    """{number: (value, detail)} of a train cell's readings."""
    loss = max(_rel(p["total_loss"], r["total_loss"]) for p, r in zip(prog["losses"], ref["losses"]))
    first = {k: _rel(prog["losses"][0][k], v) for k, v in ref["losses"][0].items() if k in prog["losses"][0]}
    grads = _leaf_gaps(prog["grad_norms"], ref["grad_norms"])
    median_grad = statistics.median(ref["grad_norms"].values())
    moved = lambda n: ref["grad_norms"][n] >= TINY_GRAD * median_grad  # noqa: E731
    large = lambda n: ref["numel"][n] >= LARGE_LEAF  # noqa: E731
    changes = _leaf_gaps(prog["change_norms"], ref["change_norms"], moved)
    grads_large = _leaf_gaps(prog["grad_norms"], ref["grad_norms"], large)
    changes_large = _leaf_gaps(prog["change_norms"], ref["change_norms"], lambda n: moved(n) and large(n))
    return {
        "loss_gap": (loss, None),
        "loss_gap_step1": (first["total_loss"], None),
        "contrastive_gap_step1": (first.get("contrastive_loss", float("nan")), None),
        "spectral_gap_step1": (first["spectral_loss"], None),
        "grad_gap": _worst(grads),
        "grad_gap_median": (statistics.median(grads.values()), None),
        "change_gap": _worst(changes),
        "change_gap_median": (statistics.median(changes.values()), None),
        "grad_gap_large": _worst(grads_large),
        "change_gap_large": _worst(changes_large),
        "_left_out": (len(ref["grad_norms"]) - len(changes), sorted(set(ref["grad_norms"]) - set(changes))),
    }


def root_flips(prog_bits: np.ndarray, ref_bits: np.ndarray, tables) -> np.ndarray:
    """Per clip, the simplices whose bit differs while all their faces'
    bits agree. Bits: [N, S_total] bool, ranks concatenated."""
    diff = prog_bits != ref_bits
    v, e, t, _ = tables.sizes
    dv, de, dt, dtt = diff[:, :v], diff[:, v : v + e], diff[:, v + e : v + e + t], diff[:, v + e + t :]
    roots = dv.sum(axis=1)
    for rank_diff, face_diff, faces in ((de, dv, tables.edges), (dt, de, tables.tri_edges),
                                        (dtt, dt, tables.tet_tris)):
        roots = roots + (rank_diff & ~face_diff[:, faces].any(axis=2)).sum(axis=1)
    return roots


def wave_gap(prog_wave: np.ndarray, ref_wave: np.ndarray) -> np.ndarray:
    """Per clip, ||program - reference|| / ||reference|| over [N, T]."""
    num = np.linalg.norm((prog_wave - ref_wave).astype(np.float64), axis=1)
    return num / np.maximum(np.linalg.norm(ref_wave.astype(np.float64), axis=1), 1e-30)


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]) for every number that has a
    limit; a number that is not finite fails."""
    rows = [(name, numbers[name][0], limits[name]) for name in limits]
    correct = all(np.isfinite(v) and v <= lim for _, v, lim in rows)
    return correct, rows
