"""Audio decoder: simplicial message passing -> cross-attention -> upsampling.

Port of ``topo_audio_autoencoder_tpu.models.decoder``. Every stage is
masked-static:

- the SCCN (``GradientSCCN``, or ``JumpingKnowledgeSCCN`` with
  ``use_jumping_knowledge``) runs over all simplices, inactive ones carrying
  zero operator rows/cols, or over the packed rows of ``PackedOperators``;
- the query sequence comes from the active vertex features, packed first
  by a stable sort, with the tail zeroed (the temporal convs' zero
  padding), GroupNorm moments over the valid steps only, and a linear
  resize of the variable-length sequence to ``desired_length // 16``;
- the cross-attention memory is all rank 1-3 simplices (packed ranks: their
  K packed rows) with inactive keys masked (``ops.attention``, a CUDA
  kernel on the card).

Tensors are channels-last ``[B, T, C]`` between stages, as in the JAX
package; the convs run on the NCW transpose.

The two linear resizes gather along time with repeated indices. Their
backward adds each input step's cotangents in a fixed order (an adjoint
gather and a sum; a product with the [out, T] interpolation matrix):
autograd's own backward of a gather adds them with atomics on the card, in
an order that changes from run to run.
"""

from __future__ import annotations

from functools import lru_cache

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import fused_masked_attention
from ..topology.builder import SimplicialOperators
from ..topology.rectifier import index_adjoint
from .encoder import gelu, group_norm, layer_norm
from .init import init_standard_module
from .sccn import GradientSCCN, JumpingKnowledgeSCCN


@lru_cache(maxsize=64)
def _resize_plan(t: int, out_len: int, device: torch.device) -> tuple:
    """The source steps and weights of a linear resize T -> out_len
    (align_corners=False), and the adjoint of its two gathers, built once
    per (T, out_len, device) (with inference mode off, so that a backward
    may save them)."""
    with torch.inference_mode(False), torch.no_grad():
        src = (torch.arange(out_len, dtype=torch.float32, device=device) + 0.5) * (t / out_len) - 0.5
        src = torch.clamp(src, 0.0, t - 1.0)
        i0 = torch.floor(src).to(torch.long)
        i1 = torch.clamp(i0 + 1, max=t - 1)
        w = (src - i0)[:, None]
        adjoint = torch.as_tensor(index_adjoint(torch.cat([i0, i1]).cpu().numpy(), t), device=device)
    return i0, i1, w, adjoint


class _Resize(torch.autograd.Function):
    """``x[..., i0, :] * (1 - w) + x[..., i1, :] * w``; the backward sums
    each step's two weighted cotangent rows over ``adjoint``."""

    @staticmethod
    def forward(ctx, x, i0, i1, w, adjoint):
        ctx.save_for_backward(w, adjoint)
        return x[..., i0, :] * (1.0 - w) + x[..., i1, :] * w

    @staticmethod
    def backward(ctx, g):
        w, adjoint = ctx.saved_tensors
        rows = torch.cat([g * (1.0 - w), g * w, g.new_zeros(*g.shape[:-2], 1, g.shape[-1])], dim=-2)
        return rows[..., adjoint, :].sum(dim=-2), None, None, None, None


def linear_resize(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """Linear interpolation along axis -2 (time), align_corners=False.
    x: [..., T, C] -> [..., out_len, C]."""
    i0, i1, w, adjoint = _resize_plan(x.shape[-2], out_len, x.device)
    return _Resize.apply(x, i0, i1, w.to(x.dtype), adjoint)


class _MaskedResize(torch.autograd.Function):
    """Per-row ``gather(x, i0) * (1 - w) + gather(x, i1) * w`` over
    [B, T, C]; the backward is the product with the transposed [B, out, T]
    interpolation matrix."""

    @staticmethod
    def forward(ctx, x, i0, i1, w):
        ctx.save_for_backward(i0, i1, w)
        ctx.steps = x.shape[1]
        c = x.shape[-1]
        g0 = torch.gather(x, 1, i0[..., None].expand(-1, -1, c))
        g1 = torch.gather(x, 1, i1[..., None].expand(-1, -1, c))
        return g0 * (1.0 - w) + g1 * w

    @staticmethod
    def backward(ctx, g):
        i0, i1, w = ctx.saved_tensors
        interp = (F.one_hot(i0, ctx.steps).to(g.dtype) * (1.0 - w)
                  + F.one_hot(i1, ctx.steps).to(g.dtype) * w)  # [B, out, T]
        return interp.transpose(1, 2) @ g, None, None, None


def masked_linear_resize(
    x: torch.Tensor, valid_len: torch.Tensor, out_len: int
) -> torch.Tensor:
    """Resize [B, T, C] treating only the first ``valid_len[b]`` steps as
    the source sequence. ``valid_len``: [B] ints."""
    vl = valid_len.to(torch.float32)[:, None]  # [B, 1]
    j = torch.arange(out_len, dtype=torch.float32, device=x.device)[None, :]
    hi = torch.clamp(vl - 1.0, min=0.0)
    src = torch.minimum(torch.clamp((j + 0.5) * vl / out_len - 0.5, min=0.0), hi)
    i0 = torch.floor(src).to(torch.long)  # [B, out]
    i1 = torch.minimum(i0 + 1, torch.clamp(valid_len[:, None].to(torch.long) - 1, min=0))
    w = (src - i0)[..., None].to(x.dtype)
    return _MaskedResize.apply(x, i0, i1, w)


def pack_active(feats: torch.Tensor, mask: torch.Tensor):
    """Stable-sort active tokens to the front and zero the tail.

    feats [B, S, C], mask [B, S] in {0,1} -> (packed [B, S, C], count [B]).
    """
    order = torch.argsort(1.0 - mask, dim=-1, stable=True)  # active first
    packed = torch.gather(feats, 1, order[..., None].expand(-1, -1, feats.shape[-1]))
    count = mask.sum(dim=-1).to(torch.int32)
    pos_valid = torch.arange(mask.shape[-1], device=mask.device)[None, :] < count[:, None]
    return packed * pos_valid[..., None], count


class MaskedGroupNorm(nn.Module):
    """GroupNorm over [B, T, C] whose moments ignore masked time steps
    (eps 1e-5, as the JAX module sets it)."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, pos_valid: torch.Tensor) -> torch.Tensor:
        b, t, c = x.shape
        g = self.num_groups
        xg = x.reshape(b, t, g, c // g)
        m = pos_valid[:, :, None, None].to(x.dtype)  # [B, T, 1, 1]
        denom = torch.clamp(m.sum(dim=(1, 3), keepdim=True) * (c // g), min=1.0)
        mean = (xg * m).sum(dim=(1, 3), keepdim=True) / denom
        var = (((xg - mean) ** 2) * m).sum(dim=(1, 3), keepdim=True) / denom
        y = (xg - mean) / torch.sqrt(var + self.eps)
        y = y.reshape(b, t, c) * self.weight + self.bias
        return y * pos_valid[..., None]


class BottleneckProj(nn.Module):
    """Dense(C/2) + LN + GELU + Dense(C) + LN key/value projection."""

    def __init__(self, channels: int):
        super().__init__()
        self.Dense_0 = nn.Linear(channels, channels // 2)
        self.LayerNorm_0 = layer_norm(channels // 2)
        self.Dense_1 = nn.Linear(channels // 2, channels)
        self.LayerNorm_1 = layer_norm(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = gelu(self.LayerNorm_0(self.Dense_0(x)))
        return self.LayerNorm_1(self.Dense_1(y))


class CrossAttention(nn.Module):
    """Multi-head dot-product attention with a key mask; the core runs in
    fp32 through ``ops.attention.fused_masked_attention``."""

    def __init__(self, channels: int, num_heads: int = 4):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(channels, channels)
        self.k_proj = nn.Linear(channels, channels)
        self.v_proj = nn.Linear(channels, channels)
        self.out_proj = nn.Linear(channels, channels)

    def forward(self, query, keys, values, key_mask):
        out = fused_masked_attention(
            self.q_proj(query), self.k_proj(keys), self.v_proj(values),
            key_mask, self.num_heads,
        )
        return self.out_proj(out)


def _grouped_conv(channels: int, groups: int) -> nn.Conv1d:
    return nn.Conv1d(channels, channels, 3, padding=1, groups=groups)


def _ncw(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply an NCW module to channels-last [B, T, C]."""
    return conv(x.transpose(1, 2)).transpose(1, 2)


class AudioDecoder(nn.Module):
    """Simplicial features -> [B, T, output_channels] subband waveforms."""

    def __init__(
        self,
        sccn_hidden_dim: int = 64,
        initial_sequence_length: int = 250,
        output_channels: int = 16,
        n_sccn_layers: int = 6,
        use_jumping_knowledge: bool = False,
        sizes=None,
    ):
        """``sizes``: the complex's rank sizes (default: every rank present),
        which tell the SCCN the ranks ``max_rank`` truncation empties."""
        super().__init__()
        c = sccn_hidden_dim
        self.initial_sequence_length = initial_sequence_length
        backbone = JumpingKnowledgeSCCN if use_jumping_knowledge else GradientSCCN
        self.sccn = backbone(c, n_sccn_layers, sizes)
        self.v2q_dense0 = nn.Linear(c, 2 * c)
        self.v2q_norm0 = layer_norm(2 * c)
        self.v2q_dense1 = nn.Linear(2 * c, c)
        self.v2q_norm1 = layer_norm(c)
        self.tconv0 = _grouped_conv(c, 8)
        self.tnorm0 = MaskedGroupNorm(8, c)
        self.tconv1 = _grouped_conv(c, 8)
        self.tnorm1 = MaskedGroupNorm(8, c)
        self.pre_attention_norm = layer_norm(c)
        self.key_proj = BottleneckProj(c)
        self.value_proj = BottleneckProj(c)
        self.attention_scale = nn.Parameter(torch.tensor(0.5))
        self.cross_attention = CrossAttention(c)
        self.post_attention_norm = layer_norm(c)
        channels = [c, c // 2, c // 4, output_channels]
        for i in range(4):
            cin, cout = channels[i], channels[min(i + 1, 3)]
            self.add_module(f"up{i}_depthwise", _grouped_conv(cin, cin))
            self.add_module(f"up{i}_pointwise", nn.Conv1d(cin, cout, 1))
            self.add_module(f"up{i}_norm", group_norm(min(8, cout), cout))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for module in self.modules():
            init_standard_module(module, generator)
        self.sccn.reset_parameters(generator)
        with torch.no_grad():
            for norm in (self.tnorm0, self.tnorm1):
                norm.weight.fill_(1.0)
                norm.bias.zero_()
            self.attention_scale.fill_(0.5)

    def forward(
        self,
        embeddings,  # per-rank [B, S_r, C]
        ops: SimplicialOperators,
        masks,  # per-rank [B, S_r]
        desired_length: int | None = None,
        train: bool = False,
    ) -> torch.Tensor:
        # The 4 upsample blocks multiply length by 16.
        init_len = (
            self.initial_sequence_length if desired_length is None else desired_length // 16
        )
        feats = self.sccn(list(embeddings), ops, train)

        # Vertex features -> query sequence
        vx = feats[0] * 0.1
        vx = gelu(self.v2q_norm0(self.v2q_dense0(vx)))
        vx = gelu(self.v2q_norm1(self.v2q_dense1(vx)))
        packed, count = pack_active(vx, masks[0])
        pos_valid = torch.arange(packed.shape[1], device=packed.device)[None, :] < count[:, None]
        y = gelu(self.tnorm0(_ncw(self.tconv0, packed), pos_valid))
        y = gelu(self.tnorm1(_ncw(self.tconv1, y), pos_valid))
        query = masked_linear_resize(y, count, init_len)

        # Cross-attention memory: ranks 1..3, scaled 0.1, masked.
        memory = torch.cat([f * 0.1 for f in feats[1:]], dim=1)
        mem_mask = torch.cat(list(masks[1:]), dim=1)
        memory = self.pre_attention_norm(memory) * mem_mask[..., None]
        query = self.pre_attention_norm(query)
        keys = self.key_proj(memory)
        values = self.value_proj(memory)
        attn = self.cross_attention(query, keys, values, mem_mask) * self.attention_scale
        x = self.post_attention_norm(query + gelu(attn))

        # Progressive upsampling: init_len -> 16 * init_len
        for i in range(4):
            x = linear_resize(x, x.shape[-2] * 2)
            x = x.transpose(1, 2)
            x = getattr(self, f"up{i}_depthwise")(x)
            x = getattr(self, f"up{i}_pointwise")(x)
            x = gelu(getattr(self, f"up{i}_norm")(x))
            x = (x * (1.0 / 2 ** (i + 1))).transpose(1, 2)
        return x  # [B, 16 * init_len, output_channels]
