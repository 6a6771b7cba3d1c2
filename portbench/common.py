"""What the traffic kinds (``portbench/kinds/<kind>.py``) share: the
program's model and the plain reference's, both holding the run's weights,
the precisions the reference computes in, and the rows a configuration's
decoder computes on.

Only the port (``topo_audio_autoencoder_torch``) is imported, and only
inside these functions.
"""

from __future__ import annotations

import contextlib
import gc
import math

import numpy as np

from . import inputs


def model_options(cfg: dict) -> dict:
    """The model's keyword arguments, as the configuration states them."""
    opts = dict(cfg["model"])
    if opts.get("pack_capacities") is not None:
        opts["pack_capacities"] = tuple(opts["pack_capacities"])
    return opts


def reference_options(cfg: dict) -> dict:
    """The plain model's keyword arguments: it runs the binary Gumbel
    sampler, soft, which the configuration has to state."""
    opts = model_options(cfg)
    if opts.pop("sampler") != "gumbel" or opts.pop("hard"):
        raise ValueError("the plain reference runs the soft binary Gumbel sampler only")
    return opts


def rank_sizes(n: int) -> list:
    """Simplices a rank on ``n`` vertices: vertices, edges, triangles,
    tetrahedra."""
    return [math.comb(n, k) for k in (1, 2, 3, 4)]


def decoder_rows(cfg: dict) -> list:
    """Rows a rank the decoder holds: a packed rank's capacity, else every
    simplex of the rank."""
    sizes = rank_sizes(cfg["model"]["num_vertices"])
    caps = cfg["model"].get("pack_capacities") or [0] * 4
    return [min(c, s) if c else s for c, s in zip(caps, sizes)]


def run_weights(torch, cfg: dict, shapes: dict, seed: int, device) -> dict:
    """The run's weights for the parameter ``shapes`` (name -> shape) of
    either model: both name and order their parameters alike."""
    sizes = rank_sizes(cfg["model"]["num_vertices"])
    return inputs.make_weights(shapes, seed, device, cfg["assumed"].get("logit_shift_per_rank"), sizes)


def reference_model(torch, cfg: dict, seed: int, device):
    """The plain model holding the run's weights."""
    from .reference import autoencoder as ref_autoencoder

    with torch.device(device):
        model = ref_autoencoder.AudioAutoencoder(**reference_options(cfg))
    model.to(device)
    shapes = {n: p.shape for n, p in model.state_dict().items()}
    model.load_state_dict(run_weights(torch, cfg, shapes, seed, device))
    return model


def program_model(torch, port, cfg: dict, seed: int, device):
    """The port's model, built as ``AudioAutoencoder.create`` builds it
    (tables, constructor, device), holding the run's weights."""
    from topo_audio_autoencoder_torch.topology.complexes import build_tables

    opts = model_options(cfg)
    n = opts.pop("num_vertices")
    with torch.device(device):
        model = port.AudioAutoencoder(tables=build_tables(n), **opts)
    model.to(device)
    shapes = {n: p.shape for n, p in model.state_dict().items()}
    model.load_state_dict(run_weights(torch, cfg, shapes, seed, device))
    return model


def free(torch) -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


@contextlib.contextmanager
def no_tf32(torch):
    """Float32 products in float32 (no TF32 in matrix products or cuDNN)
    inside; the program's settings restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def precision(torch, name: str):
    """The cast into a precision of every parameter and input of the
    reference: ``float32`` none; ``bfloat16`` the configuration's bf16
    compute (fp32 masters cast to bf16, the model's fp32 islands kept);
    ``fp8`` e4m3 with one scale a tensor (its largest magnitude maps to
    448), then bf16, the rounding passing the gradient straight through."""
    if name == "float32":
        return None
    if name == "bfloat16":
        return lambda t: t.to(torch.bfloat16)
    if name != "fp8":
        raise ValueError(f"no precision {name!r}")

    def fp8(t):
        with torch.no_grad():
            scale = t.detach().abs().amax().clamp(min=1e-30) / 448.0
            rounded = (t.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
        return (t + (rounded - t).detach()).to(torch.bfloat16)

    return fp8


def element_bytes(name: str) -> int:
    """Bytes an element of the precision a cell computes in."""
    return {"float32": 4, "bfloat16": 2}[name]


def active_rows(bits: np.ndarray, sizes, capacities) -> dict:
    """Per rank, from wire bits: the mean active simplices a clip
    (``active``), the same capped at a packed rank's capacity (``rows``,
    what the decoder computes on), and the rows the decoder holds
    (``keys``: a packed rank's capacity, else the rank's size)."""
    out = {"active": [], "rows": [], "keys": []}
    for r, part in enumerate(np.split(bits, np.cumsum(sizes)[:-1], axis=1)):
        active = part.sum(axis=1)
        cap = capacities[r] if capacities and capacities[r] else sizes[r]
        out["active"].append(float(active.mean()))
        out["rows"].append(float(np.minimum(active, cap).mean()))
        out["keys"].append(float(min(cap, sizes[r])))
    return out


def pqmf_taps(cfg: dict) -> int:
    """The PQMF filters' length for the configuration (the plain design)."""
    from .reference.pqmf import PQMF

    return PQMF(cfg["model"]["pqmf_attenuation"], cfg["model"]["num_bands"]).taps
