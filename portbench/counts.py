"""The work a step or a request needs, from shapes and masks alone, and the
card's peaks: the yardstick of the ``mfu`` and ``*_roofline`` metrics.

FLOPs count the multiply-adds (2 FLOP each) of convolutions, dense layers,
the SCCN's incidence products (each simplex's faces, not a dense
membership product), its channel mixes and combine MLPs, attention on the
active keys, and the spectral loss's FFTs (10 T log2 n a signal and
scale). Normalisations and activations are not counted. A train step is
three forwards (forward, and a backward of twice its work) with no
recomputation.
"""

from __future__ import annotations

import math

# The decoder's cross-attention heads (the model's CrossAttention).
ATTENTION_HEADS = 4
# One NVIDIA H100 SXM (data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}

# Message carriers an SCCN layer combines per rank, every rank present.
_MESSAGES = {0: 2, 1: 3, 2: 3, 3: 2}


def _out_len(length: int, kernel: int, stride: int) -> int:
    return (length + 2 * ((kernel - 1) // 2) - kernel) // stride + 1


def conv_flops(cout: int, cin_per_group: int, kernel: int, out_len: int) -> float:
    return 2.0 * cout * cin_per_group * kernel * out_len


def pqmf_flops(samples: int, taps: int) -> float:
    """Analysis (or synthesis) of one clip: M filters of ``taps`` at every
    M-th sample, M outputs a step."""
    return 2.0 * taps * samples


def encoder_flops(samples: int, bands: int, total_simplices: int, taps: int) -> float:
    """One clip through PQMF analysis, the conv stacks and the MLP."""
    nb = bands
    n = samples // nb
    flops = pqmf_flops(samples, taps)
    # (cout, cin per group, kernel, stride) in order; the length follows.
    stages = [
        (8 * nb, 1, 15, 2), (16 * nb, 8, 7, 2), (16 * nb, 16, 5, 2),  # per-band stacks
        (12 * nb, 4 * nb, 5, 1), (8 * nb, 12 * nb, 7, 1),  # cross-band merge
        (8 * nb, nb, 7, 4), (8 * nb, nb, 7, 2), (8 * nb, 8 * nb, 3, 2),  # temporal reduction
    ]
    for cout, cin, k, s in stages:
        n = _out_len(n, k, s)
        flops += conv_flops(cout, cin, k, n)
    flat = n * 8 * nb
    flops += 2.0 * (flat * 2048 + 2048 * 1024 + 1024 * total_simplices)
    return flops


def sccn_layer_flops(rows, channels: int) -> float:
    """One SCCN layer over per-rank row counts ``rows`` (4 numbers)."""
    c = channels
    flops = 0.0
    for r in range(1, 4):  # down_r and up_r: each r-simplex's r+1 faces
        flops += 2 * 2.0 * (r + 1) * rows[r] * c
    for r in range(4):
        if r < 3:  # A_r from down_{r+1}: each (r+1)-simplex's faces again
            flops += 2.0 * (r + 2) * rows[r + 1] * c
        else:
            flops += 2.0 * 4 * rows[3] * c
        m = _MESSAGES[r]
        flops += m * (2.0 * rows[r] * c * c)  # channel mixes
        flops += m * (2.0 * rows[r] * c * c + 2.0 * rows[r] * c)  # combine MLP and score
    return flops


def attention_fwd_counts(queries: int, channels: int, heads: int, active_keys: float, keys: float,
                         clips: int, elt: int) -> tuple:
    """(FLOPs, bytes) of the masked attention forward over ``clips`` clips:
    QK^T and PV on the active keys; q, the active rows of K and V, the mask
    (fp32), the output and the fp32 log-sum-exp each moved once."""
    flops = 4.0 * queries * channels * active_keys
    nbytes = (2 * clips * queries * channels * elt + 2 * active_keys * channels * elt
              + keys * 4 + clips * heads * queries * 4)
    return flops, nbytes


def attention_bwd_counts(queries: int, channels: int, heads: int, active_keys: float, keys: float,
                         clips: int, elt: int) -> tuple:
    """(FLOPs, bytes) of the backward: S, dP, dV, dK and dQ on the active
    keys (10 Q C FLOP a key); q, O, dO and dq, the active rows of K and V,
    all of dK and dV, the mask and the log-sum-exp each moved once."""
    flops = 10.0 * queries * channels * active_keys
    nbytes = (4 * clips * queries * channels * elt + 2 * active_keys * channels * elt
              + 2 * keys * channels * elt + keys * 4 + clips * heads * queries * 4)
    return flops, nbytes


def decoder_flops(rows, active_keys: float, samples: int, bands: int, channels: int, layers: int,
                  taps: int) -> float:
    """One clip from its per-rank active rows through the SCCN, the query
    path, the cross-attention on ``active_keys`` keys, the upsampling and
    PQMF synthesis."""
    c = channels
    queries = samples // bands // 16
    flops = layers * sccn_layer_flops(rows, c)
    flops += 2.0 * rows[0] * (c * 2 * c + 2 * c * c)  # vertex -> query dense layers
    flops += 2 * conv_flops(c, c // 8, 3, rows[0])  # the two grouped temporal convs
    memory = rows[1] + rows[2] + rows[3]
    flops += 2 * 2.0 * memory * (c * c // 2 + c // 2 * c)  # key and value bottlenecks
    flops += 2.0 * (2 * queries * c * c + 2 * memory * c * c)  # q, out and k, v projections
    flops += 4.0 * queries * c * active_keys
    chans = [c, c // 2, c // 4, bands]
    length = queries
    for i in range(4):
        cin, cout = chans[i], chans[min(i + 1, 3)]
        length *= 2
        flops += conv_flops(cin, 1, 3, length) + conv_flops(cout, cin, 1, length)
    return flops + pqmf_flops(samples, taps)


def spectral_loss_flops(samples: int, scales=(2048, 1024, 512, 256, 128)) -> float:
    """The multiscale STFT of one signal: 10 T log2 n a scale."""
    return sum(10.0 * samples * math.log2(n) for n in scales)


def train_step_flops(cfg: dict, sizes, batch: int, group: int, taps: int) -> float:
    """Model FLOPs of one train step: every clip encoded, the anchors
    decoded over every row the decoder holds (the soft latent keeps all of
    them active; a packed rank holds its capacity), the loss over the
    anchors' reconstructions and targets; times three."""
    m = cfg["model"]
    samples, bands, c = m["num_samples"], m["num_bands"], m["sccn_hidden_dim"]
    forward = batch * group * encoder_flops(samples, bands, sum(sizes), taps)
    caps = m.get("pack_capacities") or [0] * 4
    rows = [min(cap, size) if cap else size for cap, size in zip(caps, sizes)]
    keys = rows[1] + rows[2] + rows[3]
    forward += batch * decoder_flops(rows, keys, samples, bands, c, m["n_sccn_layers"], taps)
    forward += 2 * batch * spectral_loss_flops(samples)
    return 3.0 * forward


def codec_request_flops(cfg: dict, sizes, clips: int, active_rows, taps: int) -> float:
    """Model FLOPs of one request: ``clips`` clips encoded and decoded over
    their mean active rows per rank (``active_rows``, packed ranks capped
    at their capacity)."""
    m = cfg["model"]
    samples, bands, c = m["num_samples"], m["num_bands"], m["sccn_hidden_dim"]
    keys = active_rows[1] + active_rows[2] + active_rows[3]
    per_clip = encoder_flops(samples, bands, sum(sizes), taps)
    per_clip += decoder_flops(active_rows, keys, samples, bands, c, m["n_sccn_layers"], taps)
    return clips * per_clip


def roofline_seconds(flops: float, nbytes: float, peak: str) -> tuple:
    """The least time the card could take, and which bound sets it."""
    t_ops = flops / PEAK_FLOPS[peak]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
