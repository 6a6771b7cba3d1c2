"""Masked multi-head cross-attention: the plain torch version and the
wrapper of the hand-written CUDA forward kernel.

Port of ``topo_audio_autoencoder_tpu.ops.attention``. Semantics:

- scores scaled by 1/sqrt(D), masked keys scored -1e9,
- softmax and accumulation in fp32 whatever the input dtype,
- a batch element whose memory is fully masked gives exactly zero output.

``attention_fwd`` runs ``csrc/masked_attention_fwd.cu`` for CUDA tensors
and the plain version ``attention_fwd_plain`` for CPU tensors; it never
falls back from one to the other. Besides the output it returns the per-row
log-sum-exp L [B, H, Q] (fp32, +inf for a fully masked element), the
residual a backward needs to recompute the weights as exp(s - L).
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (2, 4, 8, 16, 32)


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


@lru_cache(maxsize=None)
def _kernel():
    """The C entry point of csrc/masked_attention_fwd.cu, built on first use."""
    from ..cuda_build import load

    fn = load("masked_attention_fwd").masked_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch_cuda(query, keys, values, key_mask, num_heads):
    b, tq, c = query.shape
    tm = keys.shape[1]
    d = c // num_heads
    if query.dtype not in _DTYPE_CODES:
        raise TypeError(f"the CUDA kernel takes float32 or bfloat16, not {query.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head dims {_HEAD_DIMS}, not {d}")
    if not (query.is_contiguous() and keys.is_contiguous() and values.is_contiguous()):
        raise ValueError("the CUDA kernel takes contiguous query, keys and values")
    if b == 0 or tq == 0 or b > 65535 or num_heads > 65535:
        raise ValueError(f"the CUDA kernel does not take B={b}, Q={tq}, H={num_heads}")
    mask = key_mask.to(torch.float32).contiguous()
    out = torch.empty_like(query)
    lse = torch.empty((b, num_heads, tq), dtype=torch.float32, device=query.device)
    fn = _kernel()
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream(query.device).cuda_stream
        err = fn(
            query.data_ptr(), keys.data_ptr(), values.data_ptr(), mask.data_ptr(),
            out.data_ptr(), lse.data_ptr(),
            b, tq, tm, c, num_heads, _DTYPE_CODES[query.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"masked_attention_fwd launch failed: CUDA error {err}")
    attention_fwd.launches += 1
    return out, lse


def attention_fwd(query, keys, values, key_mask, num_heads):
    """Masked attention forward -> (out [B, Q, C], lse [B, H, Q] fp32).

    CPU tensors take the plain version; CUDA tensors launch the CUDA
    kernel (``launches`` counts those launches); any other device raises.
    """
    _check(query, keys, values, key_mask, num_heads)
    device = query.device
    if device.type == "cpu":
        return attention_fwd_plain(query, keys, values, key_mask, num_heads)
    if device.type != "cuda":
        raise ValueError(f"attention_fwd runs on cpu or cuda tensors, not {device}")
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (query, keys, values)
    ):
        raise NotImplementedError(
            "the attention backward kernel belongs to the training slice of "
            "the PyTorch port: run the CUDA forward without gradients"
        )
    return _launch_cuda(query, keys, values, key_mask, num_heads)


attention_fwd.launches = 0


def fused_masked_attention(query, keys, values, key_mask, num_heads):
    """Multi-head dot-product attention with a key-padding mask.

    query [B, Q, C], keys/values [B, M, C], key_mask [B, M] {0,1}.
    Returns [B, Q, C]. C = num_heads * head_dim.
    """
    return attention_fwd(query, keys, values, key_mask, num_heads)[0]
