"""Masked multi-head cross-attention in plain torch, fp32 inside.

Semantics of the port's ``ops.attention``: scores scaled by 1/sqrt(D),
masked keys scored -1e9, softmax and accumulation in fp32 whatever the
input dtype, and a batch element whose memory is fully masked gives
exactly zero output. Gradients come from autograd.
"""

from __future__ import annotations

import math

import torch


def masked_attention(query, keys, values, key_mask, num_heads):
    """query [B, Q, C], keys/values [B, M, C], key_mask [B, M] -> out
    [B, Q, C] in the query's dtype."""
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
    return out.to(query.dtype)
