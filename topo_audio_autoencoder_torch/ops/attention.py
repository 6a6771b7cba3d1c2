"""Masked multi-head cross-attention: the plain torch versions and the
wrappers of the hand-written CUDA forward and backward kernels.

Port of ``topo_audio_autoencoder_tpu.ops.attention``. Semantics:

- scores scaled by 1/sqrt(D), masked keys scored -1e9,
- softmax and accumulation in fp32 whatever the input dtype,
- a batch element whose memory is fully masked gives exactly zero output
  and exactly zero gradients.

``attention_fwd`` runs ``csrc/masked_attention_fwd.cu`` for CUDA tensors
and the plain version ``attention_fwd_plain`` for CPU tensors; it never
falls back from one to the other. The CUDA forward splits the keys into
``_num_splits`` contiguous ranges, one block per range, and merges the
ranges' partial softmax sums in a second kernel, in split order;
``attention_fwd_split_plain`` does the same arithmetic in torch, for the
tests. Besides the output it returns the per-row
log-sum-exp L [B, H, Q] (fp32, +inf for a fully masked element), the
residual from which ``attention_bwd`` (``csrc/masked_attention_bwd.cu``,
or ``attention_bwd_plain`` on the CPU) recomputes the weights as
exp(s - L). The CUDA backward computes dk and dv per key range and dq as
the forward's split over keys, summing the splits' partial dq in split
order in a merge kernel; ``attention_bwd_split_plain`` does that dq
arithmetic in torch, for the tests. ``MaskedAttention`` ties the two into
one autograd Function, the same on both devices.

The spans ``taa.attention.fwd`` (round ``fused_masked_attention``) and
``taa.attention.bwd`` (round ``MaskedAttention.backward``) name the
attention layer's forward and backward in a profile, whatever implements
them: a later implementation keeps these two spans round what replaces
the kernels, so a measurement of the layer keeps reading it.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache

import torch

from ..utils.profiling import span

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (2, 4, 8, 16, 32)
# The forward kernel's tiling (csrc/masked_attention_fwd.cu): query rows per
# block, keys per window; a split over keys is a range of whole windows.
ROWS_PER_BLOCK = 256
KEY_TILE = 64
# Blocks the split aims at on each SM.
_BLOCKS_PER_SM = 4
# The backward's dk/dv kernel (csrc/masked_attention_bwd.cu): threads per
# block, each owning two keys at head dims up to 16 and one above.
DKDV_THREADS = 128


def attention_fwd_plain(query, keys, values, key_mask, num_heads):
    """Plain torch forward, computed in fp32. query [B, Q, C], keys/values
    [B, M, C], key_mask [B, M] -> (out [B, Q, C] in the input dtype,
    lse [B, H, Q] fp32)."""
    b, tq, c = query.shape
    tm = keys.shape[1]
    h, d = num_heads, c // num_heads
    q = query.to(torch.float32).reshape(b, tq, h, d)
    k = keys.to(torch.float32).reshape(b, tm, h, d)
    v = values.to(torch.float32).reshape(b, tm, h, d)
    scores = torch.einsum("bqhd,bmhd->bhqm", q, k) / math.sqrt(d)
    active = (key_mask > 0)[:, None, None, :]
    scores = torch.where(active, scores, torch.full_like(scores, -1e9))
    attn = torch.softmax(scores, dim=-1)
    any_valid = (key_mask.sum(dim=-1) > 0)[:, None, None, None]
    attn = torch.where(any_valid, attn, torch.zeros_like(attn))
    out = torch.einsum("bhqm,bmhd->bqhd", attn, v).reshape(b, tq, c)
    lse = torch.logsumexp(scores, dim=-1)
    lse = torch.where(any_valid[..., 0], lse, torch.full_like(lse, math.inf))
    return out.to(query.dtype), lse


def _num_splits(b, h, tq, m, num_sms):
    """Splits over keys of the CUDA forward at this shape: about
    ``_BLOCKS_PER_SM`` blocks on each of ``num_sms`` SMs, at least 1 and at
    most one 64-key window each. A pure function of its arguments."""
    windows = -(-m // KEY_TILE)
    blocks = -(-tq // ROWS_PER_BLOCK) * h * b
    return max(1, min(-(-_BLOCKS_PER_SM * num_sms // blocks), windows))


def split_bounds(m, num_splits, tile=KEY_TILE):
    """Key ranges [lo, hi) of the splits: split s takes the whole windows
    [s*T/S, (s+1)*T/S) of the T = ceil(m/tile) windows."""
    windows = -(-m // tile)
    return [
        (s * windows // num_splits * tile, min((s + 1) * windows // num_splits * tile, m))
        for s in range(num_splits)
    ]


def attention_fwd_split_plain(query, keys, values, key_mask, num_heads, num_splits, tile=KEY_TILE):
    """The CUDA forward's arithmetic in torch (fp32), for the tests: per
    split and row the max m_s, the sum l_s and the unnormalised accumulator
    acc_s over that split's active keys (m_s = -inf, l_s = 0 for a split
    with none), merged in split order. Returns (out [B, Q, C] in the input
    dtype, lse [B, H, Q] fp32), zeros and +inf where the element is fully
    masked."""
    b, tq, c = query.shape
    h, d = num_heads, c // num_heads
    q, k, v = (_split(t, num_heads) for t in (query, keys, values))
    active = (key_mask > 0)[:, None, None, :]  # [B, 1, 1, M]
    parts = []
    for lo, hi in split_bounds(keys.shape[1], num_splits, tile):
        s = torch.einsum("bqhd,bmhd->bhqm", q, k[:, lo:hi]) / math.sqrt(d)
        s = torch.where(active[..., lo:hi], s, -math.inf)
        m_s = s.amax(dim=-1) if hi > lo else s.new_full((b, h, tq), -math.inf)
        p = torch.exp(s - torch.where(torch.isinf(m_s), 0.0, m_s)[..., None])
        parts.append((m_s, p.sum(dim=-1), torch.einsum("bhqm,bmhd->bhqd", p, v[:, lo:hi])))
    m = torch.stack([m_s for m_s, _, _ in parts]).amax(dim=0)
    valid = m > -math.inf
    m_safe = torch.where(valid, m, 0.0)
    l = torch.zeros_like(m)
    acc = q.new_zeros((b, h, tq, d))
    for m_s, l_s, acc_s in parts:  # in split order
        w = torch.exp(m_s - m_safe)  # 0 for a split with no active key
        l = l + w * l_s
        acc = acc + w[..., None] * acc_s
    out = torch.where(valid[..., None], acc / torch.where(valid, l, 1.0)[..., None], 0.0)
    lse = torch.where(valid, m + torch.log(l), math.inf)
    return out.permute(0, 2, 1, 3).reshape(b, tq, c).to(query.dtype), lse


def reference_attention(query, keys, values, key_mask, num_heads):
    """Output of the plain version only: the port of the JAX package's
    ``_reference_attention``."""
    return attention_fwd_plain(query, keys, values, key_mask, num_heads)[0]


def _check(query, keys, values, key_mask, num_heads):
    if query.dim() != 3 or keys.dim() != 3 or values.dim() != 3:
        raise ValueError("query, keys and values must be [B, T, C]")
    b, tq, c = query.shape
    if keys.shape != values.shape or keys.shape[0] != b or keys.shape[2] != c:
        raise ValueError(
            f"keys/values {tuple(keys.shape)}/{tuple(values.shape)} do not "
            f"match query {tuple(query.shape)}"
        )
    if key_mask.shape != keys.shape[:2]:
        raise ValueError(f"key_mask {tuple(key_mask.shape)} must be [B, M]")
    if num_heads <= 0 or c % num_heads:
        raise ValueError(f"C={c} is not divisible by num_heads={num_heads}")
    if not (query.dtype == keys.dtype == values.dtype):
        raise ValueError("query, keys and values must share one dtype")
    devices = {t.device for t in (query, keys, values, key_mask)}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")


def _split(x, num_heads):
    """[B, T, C] -> [B, T, H, D] in fp32."""
    b, t, c = x.shape
    return x.to(torch.float32).reshape(b, t, num_heads, c // num_heads)


def attention_bwd_plain(query, keys, values, key_mask, out, lse, dout, num_heads):
    """Plain torch backward: the explicit softmax VJP in fp32.

    Recomputes P = exp(s - L) on the active keys (0 on masked keys and in a
    fully masked element, whose L is +inf), then ds = P (dP - delta) with
    delta_i = dO_i . O_i (which equals sum_j P_ij dP_ij). Returns
    (dq, dk, dv) in the dtypes of query, keys and values.
    """
    d = query.shape[-1] // num_heads
    scale = 1.0 / math.sqrt(d)
    q, k, v, o, do = (_split(t, num_heads) for t in (query, keys, values, out, dout))
    active = (key_mask > 0)[:, None, None, :]  # [B, 1, 1, M]
    s = torch.einsum("bqhd,bmhd->bhqm", q, k) * scale
    p = torch.where(active, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    dp = torch.einsum("bqhd,bmhd->bhqm", do, v)
    delta = (do * o).sum(dim=-1).permute(0, 2, 1)  # [B, H, Q]
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqm,bmhd->bqhd", ds, k) * scale
    dk = torch.einsum("bhqm,bqhd->bmhd", ds, q) * scale
    dv = torch.einsum("bhqm,bqhd->bmhd", p, do)
    return (
        dq.reshape(query.shape).to(query.dtype),
        dk.reshape(keys.shape).to(keys.dtype),
        dv.reshape(values.shape).to(values.dtype),
    )


def attention_bwd_split_plain(query, keys, values, key_mask, out, lse, dout, num_heads, num_splits,
                              tile=KEY_TILE):
    """The CUDA backward's dq arithmetic in torch (fp32), for the tests:
    per split of whole ``tile``-key windows the partial sum_j ds_ij k_j over
    that split's active keys (0 for a split with none), summed in split
    order and then scaled by 1/sqrt(D). dk and dv as in
    ``attention_bwd_plain``. Returns (dq, dk, dv) in the input dtypes."""
    d = query.shape[-1] // num_heads
    scale = 1.0 / math.sqrt(d)
    q, k, v, o, do = (_split(t, num_heads) for t in (query, keys, values, out, dout))
    active = (key_mask > 0)[:, None, None, :]  # [B, 1, 1, M]
    delta = (do * o).sum(dim=-1).permute(0, 2, 1)[..., None]  # [B, H, Q, 1]
    dq = q.new_zeros(q.shape)
    for lo, hi in split_bounds(keys.shape[1], num_splits, tile):  # in split order
        s = torch.einsum("bqhd,bmhd->bhqm", q, k[:, lo:hi]) * scale
        p = torch.where(active[..., lo:hi], torch.exp(s - lse[..., None]), 0.0)
        ds = p * (torch.einsum("bqhd,bmhd->bhqm", do, v[:, lo:hi]) - delta)
        dq = dq + torch.einsum("bhqm,bmhd->bqhd", ds, k[:, lo:hi])
    _, dk, dv = attention_bwd_plain(query, keys, values, key_mask, out, lse, dout, num_heads)
    return (dq * scale).reshape(query.shape).to(query.dtype), dk, dv


@lru_cache(maxsize=None)
def _kernel():
    """The C entry point of csrc/masked_attention_fwd.cu, built on first use."""
    from ..cuda_build import load

    fn = load("masked_attention_fwd").masked_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def fwd_plan(query, keys, num_heads):
    """(splits, blocks of the partial kernel) of the CUDA forward for these
    CUDA inputs."""
    b, tq, _ = query.shape
    splits = _num_splits(b, num_heads, tq, keys.shape[1], _sm_count(query.device.index))
    return splits, -(-tq // ROWS_PER_BLOCK) * num_heads * b * splits


def _launch_cuda(query, keys, values, key_mask, num_heads):
    b, tq, c = query.shape
    tm = keys.shape[1]
    _check_cuda(query, keys, values, num_heads)
    splits, _ = fwd_plan(query, keys, num_heads)
    mask = key_mask.to(torch.float32).contiguous()
    out = torch.empty_like(query)
    lse = torch.empty((b, num_heads, tq), dtype=torch.float32, device=query.device)
    # The splits' fp32 partials: acc [S, B, H, Q, D], then m and l [S, B, H, Q].
    work = torch.empty(splits * b * tq * (c + 2 * num_heads), dtype=torch.float32, device=query.device)
    fn = _kernel()
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream(query.device).cuda_stream
        err = fn(
            query.data_ptr(), keys.data_ptr(), values.data_ptr(), mask.data_ptr(),
            out.data_ptr(), lse.data_ptr(), work.data_ptr(),
            b, tq, tm, c, num_heads, splits, _DTYPE_CODES[query.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"masked_attention_fwd launch failed: CUDA error {err}")
    attention_fwd.launches += 1
    return out, lse


@lru_cache(maxsize=None)
def _bwd_kernel():
    """The C entry point of csrc/masked_attention_bwd.cu, built on first use."""
    from ..cuda_build import load

    fn = load("masked_attention_bwd").masked_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_cuda(query, keys, values, num_heads):
    b, tq, c = query.shape
    d = c // num_heads
    if query.dtype not in _DTYPE_CODES:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16, not {query.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"the CUDA kernels take head dims {_HEAD_DIMS}, not {d}")
    if not (query.is_contiguous() and keys.is_contiguous() and values.is_contiguous()):
        raise ValueError("the CUDA kernels take contiguous query, keys and values")
    if b == 0 or tq == 0 or b > 65535 or num_heads > 65535:
        raise ValueError(f"the CUDA kernels do not take B={b}, Q={tq}, H={num_heads}")


def bwd_plan(query, keys, num_heads):
    """(splits of dq, {kernel: blocks}) of the CUDA backward for these CUDA
    inputs: the dk/dv kernel's key ranges and the dq split's blocks."""
    b, tq, c = query.shape
    splits, dq_blocks = fwd_plan(query, keys, num_heads)
    keys_per_block = DKDV_THREADS * (2 if c // num_heads <= 16 else 1)
    dkdv_blocks = -(-keys.shape[1] // keys_per_block) * num_heads * b
    return splits, {"attn_bwd_dkdv": dkdv_blocks, "attn_bwd_dq_partial": dq_blocks}


def _aligned(t):
    """``t``, or a copy whose data starts on a 16-byte boundary: the
    backward kernels load rows as 16-byte vectors."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch_bwd_cuda(query, keys, values, key_mask, out, lse, dout, num_heads):
    b, tq, c = query.shape
    tm = keys.shape[1]
    _check_cuda(query, keys, values, num_heads)
    if out.shape != query.shape or dout.shape != query.shape:
        raise ValueError("out and dout must have the query's shape")
    if lse.shape != (b, num_heads, tq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be fp32 [B, H, Q], not {lse.dtype} {tuple(lse.shape)}")
    splits, _ = bwd_plan(query, keys, num_heads)
    query, keys, values = (_aligned(t) for t in (query, keys, values))
    out = out.to(query.dtype).contiguous()
    dout = _aligned(dout.to(query.dtype).contiguous())
    lse = lse.contiguous()
    mask = key_mask.to(torch.float32).contiguous()
    # Every element of dq, dk and dv is written by the kernels, masked key
    # rows as exact zeros.
    dq = torch.empty_like(query)
    dk = torch.empty_like(keys)
    dv = torch.empty_like(values)
    delta = torch.empty((b, num_heads, tq), dtype=torch.float32, device=query.device)
    # The splits' fp32 partial dq [S, B, H, Q, D].
    work = torch.empty(splits * b * tq * c, dtype=torch.float32, device=query.device)
    fn = _bwd_kernel()
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream(query.device).cuda_stream
        err = fn(
            query.data_ptr(), keys.data_ptr(), values.data_ptr(), mask.data_ptr(),
            out.data_ptr(), lse.data_ptr(), dout.data_ptr(), delta.data_ptr(), work.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, tq, tm, c, num_heads, splits, _DTYPE_CODES[query.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"masked_attention_bwd launch failed: CUDA error {err}")
    attention_bwd.launches += 1
    return dq, dk, dv


def attention_bwd(query, keys, values, key_mask, out, lse, dout, num_heads):
    """Masked attention backward -> (dq, dk, dv), from the forward's inputs,
    its output and its log-sum-exp L, and the output's gradient dout.

    CPU tensors take the plain version; CUDA tensors launch the CUDA
    kernels, four a call (``launches`` counts those calls, one per call);
    any other device raises.
    """
    _check(query, keys, values, key_mask, num_heads)
    device = query.device
    if device.type == "cpu":
        return attention_bwd_plain(query, keys, values, key_mask, out, lse, dout, num_heads)
    if device.type != "cuda":
        raise ValueError(f"attention_bwd runs on cpu or cuda tensors, not {device}")
    return _launch_bwd_cuda(query, keys, values, key_mask, out, lse, dout, num_heads)


attention_bwd.launches = 0


def attention_fwd(query, keys, values, key_mask, num_heads):
    """Masked attention forward -> (out [B, Q, C], lse [B, H, Q] fp32).

    CPU tensors take the plain version; CUDA tensors launch the CUDA
    kernels, the split and the merge (``launches`` counts those calls, one
    per call); any other device raises.
    """
    _check(query, keys, values, key_mask, num_heads)
    device = query.device
    if device.type == "cpu":
        return attention_fwd_plain(query, keys, values, key_mask, num_heads)
    if device.type != "cuda":
        raise ValueError(f"attention_fwd runs on cpu or cuda tensors, not {device}")
    return _launch_cuda(query, keys, values, key_mask, num_heads)


attention_fwd.launches = 0


def fold_vmapped(info, in_dims, *tensors) -> list:
    """The inputs of a custom Function's ``vmap`` rule with the vmapped
    axis folded into their leading (batch) axis: [K, B, ...] -> [K*B, ...].
    An input that is not vmapped is repeated K times."""
    k = info.batch_size
    out = []
    for t, d in zip(tensors, in_dims):
        t = t.movedim(d, 0) if d is not None else t.expand(k, *t.shape)
        out.append(t.reshape(k * t.shape[1], *t.shape[2:]))
    return out


class MaskedAttention(torch.autograd.Function):
    """``attention_fwd`` forward, ``attention_bwd`` backward. Saves q, k, v,
    the mask, the output and L; the mask and the head count take no
    gradient. CPU tensors run the plain versions, CUDA tensors the kernels.

    Under ``torch.func.vmap`` the vmapped axis folds into the batch axis:
    one call over K*B elements, so the forward and the backward each launch
    once for all K, as the TPU kernel runs under ``jax.vmap``."""

    @staticmethod
    def forward(query, keys, values, key_mask, num_heads):
        return attention_fwd(query, keys, values, key_mask, num_heads)

    @staticmethod
    def setup_context(ctx, inputs, output):
        query, keys, values, key_mask, num_heads = inputs
        out, lse = output
        ctx.save_for_backward(query, keys, values, key_mask, out, lse)
        ctx.num_heads = num_heads
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def vmap(info, in_dims, query, keys, values, key_mask, num_heads):
        k = info.batch_size
        q, kk, v, m = fold_vmapped(info, in_dims[:4], query, keys, values, key_mask)
        out, lse = MaskedAttention.apply(q.contiguous(), kk.contiguous(), v.contiguous(), m, num_heads)
        return (out.reshape(k, -1, *out.shape[1:]), lse.reshape(k, -1, *lse.shape[1:])), (0, 0)

    @staticmethod
    def backward(ctx, dout, _dlse):
        with span("taa.attention.bwd", device=True):
            query, keys, values, key_mask, out, lse = ctx.saved_tensors
            dq, dk, dv = attention_bwd(
                query, keys, values, key_mask, out, lse, dout.contiguous(), ctx.num_heads
            )
        return dq, dk, dv, None, None


def fused_masked_attention(query, keys, values, key_mask, num_heads):
    """Multi-head dot-product attention with a key-padding mask.

    query [B, Q, C], keys/values [B, M, C], key_mask [B, M] {0,1}.
    Returns [B, Q, C]. C = num_heads * head_dim. Differentiable in query,
    keys and values through ``MaskedAttention``.
    """
    with span("taa.attention.fwd", device=True):
        return MaskedAttention.apply(query, keys, values, key_mask, num_heads)[0]
