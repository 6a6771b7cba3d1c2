"""Everything a run feeds the program, made from ``--seed``: the weights,
the clips and the index groups. The program and the reference are handed
the same tensors.

Weights follow the flax init families the port draws from: lecun-normal
(variance 1 / fan_in) kernels, zero biases, unit norm scales, normal(1)
embedding tables, and the model's own constants. They are drawn on the
device in one call and cut into leaves; the names and shapes come from the
reference model, whose parameter names are the port's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SAMPLE_RATE = 16000.0
# Named constants of the model's init (the port's ``reset_parameters``).
CONSTANTS = {"encoder.skip_weight": 0.1, "encoder.vertex_bias": 2.0, "decoder.attention_scale": 0.5}


def sub_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for one use of the run's seed."""
    words = np.random.SeedSequence([seed, *purpose.encode()]).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def _rule(name: str, shape: torch.Size):
    """(kind, fan_in) of a leaf: 'normal' leaves are drawn, the others are
    constants."""
    leaf = name.rsplit(".", 1)[-1]
    if name in CONSTANTS:
        return "constant", CONSTANTS[name]
    if leaf.startswith("embed_rank"):
        return "normal", 1
    if leaf == "bias" or leaf.startswith("attn_b1_"):
        return "constant", 0.0
    if leaf.startswith("scale_") or (leaf == "weight" and len(shape) == 1):
        return "constant", 1.0
    if leaf.startswith(("same_rank_", "high_to_low_", "low_to_high_", "attn_w1_", "attn_w2_")):
        return "normal", shape[0]  # raw [C, C] / [C, 1] mixes, right-multiplied
    if leaf == "weight":
        return "normal", math.prod(shape[1:])  # nn.Linear / nn.Conv1d: [out, in, ...]
    raise ValueError(f"no init rule for parameter {name} {tuple(shape)}")


def make_weights(shapes: dict, seed: int, device, logit_shift=None, sizes=None) -> dict:
    """A state dict for parameter ``shapes`` (name -> shape), from ``seed``,
    on ``device`` in fp32. ``logit_shift`` (one number per rank) is added to
    the last encoder bias over each rank's simplices (``sizes``)."""
    plan = [(n, s, *_rule(n, s)) for n, s in shapes.items()]
    count = sum(math.prod(s) for _, s, kind, _ in plan if kind == "normal")
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    draws = torch.randn(count, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, kind, value in plan:
        if kind == "normal":
            n = math.prod(shape)
            out[name] = draws[at : at + n].view(shape) * (1.0 / math.sqrt(value))
            at += n
        else:
            out[name] = torch.full(shape, float(value), device=device)
    if logit_shift is not None:
        bias = out["encoder.mlp2.bias"]
        at = 0
        for shift, size in zip(logit_shift, sizes):
            bias[at : at + size] += shift
            at += size
    return out


def make_clips(count: int, samples: int, seed: int, purpose: str, device, chunk: int = 128) -> torch.Tensor:
    """[count, samples] fp32 clips on ``device``: four sines of random
    frequency (60-6,000 Hz) and amplitude (0.05-0.4) plus noise of std
    0.02, made in chunks of rows."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, purpose))
    t = torch.arange(samples, device=device, dtype=torch.float32) / SAMPLE_RATE
    out = torch.empty(count, samples, device=device)
    for i in range(0, count, chunk):
        n = min(chunk, count - i)
        freqs = 60.0 + (6000.0 - 60.0) * torch.rand(n, 4, 1, generator=gen, device=device)
        amps = 0.05 + 0.35 * torch.rand(n, 4, 1, generator=gen, device=device)
        x = (amps * torch.sin(2.0 * math.pi * freqs * t)).sum(dim=1)
        out[i : i + n] = x + 0.02 * torch.randn(n, samples, generator=gen, device=device)
    return out


def index_groups(corpus: int, steps: int, batch: int, group: int, seed: int) -> np.ndarray:
    """[steps, batch, group] int64 corpus rows. Each run of consecutive
    steps that fits in the corpus takes its rows from one permutation, so
    no row repeats within a step, nor within the first steps."""
    rng = np.random.default_rng(sub_seed(seed, "index_groups"))
    per_step = batch * group
    if per_step > corpus:
        raise ValueError(f"a step of {per_step} rows does not fit a corpus of {corpus}")
    fit = corpus // per_step
    out = []
    while len(out) < steps:
        perm = rng.permutation(corpus)
        out += [perm[i * per_step : (i + 1) * per_step] for i in range(fit)]
    return np.stack(out[:steps]).reshape(steps, batch, group).astype(np.int64)
