"""The SCCN layer's message combine in plain torch.

Per rank, up to three message carriers become one output:

    msg_m  = carrier_m @ V_m + x          (channel mix + residual)
    h_m    = gelu_tanh(msg_m @ W1 + b1)
    s_m    = h_m @ w2                      (attention score)
    attn   = softmax_m(s)                  (in fp32)
    y      = sum_m attn_m * msg_m
"""

from __future__ import annotations

import math

import torch

_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)
_GELU_C = 0.044715


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate gelu."""
    u = _SQRT_2_OVER_PI * (x + _GELU_C * x * x * x)
    return 0.5 * x * (1.0 + torch.tanh(u))


def message_combine(carriers, x, v, w1, b1, w2):
    """carriers: tuple of M [B, S, C] tensors, x [B, S, C], v [M, C, C],
    w1 [C, C], b1 [C], w2 [C, 1] -> [B, S, C]."""
    msgs = torch.stack([c @ v[i] + x for i, c in enumerate(carriers)])
    h = _gelu(msgs @ w1 + b1)
    scores = (h @ w2).to(torch.float32)  # [M, B, S, 1]
    attn = torch.softmax(scores, dim=0).to(msgs.dtype)
    return (msgs * attn).sum(dim=0)
