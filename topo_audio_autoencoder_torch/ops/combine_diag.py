"""Diagnostic variants of the fused SCCN combine: their plain torch versions
and the wrappers of their kernels, template variants of
``csrc/sccn_combine.cu``.

Counterpart of the kernels of ``benchmarks/kernel_diag.py`` (the JAX
package's harness, which stays as it is):

- the lane-packed M=2 combine, forward (``packed_combine_fwd``) and
  backward (``packed_combine_bwd``), tied into ``packed_combine`` as
  ``make_packed_combine`` ties them: the two carriers travel as one
  [P, 2C] buffer, ``swapaxes(car, 0, 1).reshape(P, 2C)``, built inside the
  wrapper and timed with it; the softmax over two messages is
  sigmoid(s0 - s1);
- three ablations of the full forward: ``combine_copy`` (y = x + sum_m
  car_m), ``combine_matmul`` (y = sum_m (car_m V_m + x)) and
  ``combine_nogelu`` (the full forward with the identity for gelu).

They are timing scaffolds: the ladder copy, matmul, nogelu, full
(``sccn_combine.combine_fwd``), packed reads where the full kernel's time
goes. Carriers are stacked [M, P, C] here, as kernel_diag passes them.
Each wrapper takes the plain version for CPU tensors and launches its
kernel for CUDA tensors, counting its launches in ``launches``; it never
falls back from one to the other.
"""

from __future__ import annotations

import torch

from .sccn_combine import (
    COPY,
    MATMUL,
    NOGELU,
    PACKED,
    _combine,
    _gelu,
    check_cuda,
    launch_backward,
    launch_forward,
    vjp_plain,
)


def pack_carriers(car: torch.Tensor) -> torch.Tensor:
    """[2, P, C] -> the lane-packed [P, 2C]: row p is [car_0[p] | car_1[p]]."""
    _, p, c = car.shape
    return car.transpose(0, 1).reshape(p, 2 * c)


def _check_stacked(car, x, m_allowed, what: str) -> None:
    if car.dim() != 3 or car.shape[1:] != x.shape or x.dim() != 2:
        raise ValueError(f"{what}: car must be [M, P, C] over x [P, C], not {tuple(car.shape)}, {tuple(x.shape)}")
    if car.shape[0] not in m_allowed:
        raise ValueError(f"{what} takes M in {m_allowed}, not {car.shape[0]}")
    if car.device != x.device or x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on one cpu or cuda device, not {car.device} and {x.device}")


# ------------------------------------------------------------- packed


def packed_combine_plain(car, x, v, w1, b1, w2):
    """Row 8's function in plain torch: from the packed carriers, with the
    softmax over two messages as sigmoid(s0 - s1). car [2, P, C], x [P, C],
    v [2, C, C], w1 [C, C], b1 [C], w2 [C, 1] -> [P, C]."""
    c = x.shape[-1]
    carp = pack_carriers(car)
    msgs = [carp[:, m * c:(m + 1) * c] @ v[m] + x for m in range(2)]
    s0, s1 = ((_gelu(mm @ w1 + b1) @ w2).to(torch.float32) for mm in msgs)
    a0 = torch.sigmoid(s0 - s1).to(x.dtype)
    return msgs[0] * a0 + msgs[1] * (1 - a0)


def packed_combine_bwd_plain(car, x, v, w1, b1, w2, dy):
    """Row 9's function in plain torch: autograd through
    ``packed_combine_plain`` -> (dcar [2, P, C], dx, dv, dw1, db1, dw2)."""
    return vjp_plain(packed_combine_plain, (car, x, v, w1, b1, w2), dy)


def _packed_operands(car, x, v, w1, b1, w2, what):
    carp = pack_carriers(car)  # a copy: the packing is part of the timed call
    x, v, w1, b1, w2 = (t.contiguous() for t in (x, v, w1, b1, w2))
    check_cuda([x, carp, v, w1, b1, w2], what)
    c = x.shape[-1]
    return carp, [carp.data_ptr(), carp.data_ptr() + c * carp.element_size()], x, v, w1, b1, w2


def packed_combine_fwd(car, x, v, w1, b1, w2):
    """Row 8: the combine at M=2 on lane-packed carriers -> y [P, C].
    ``car`` [2, P, C] is packed to [P, 2C] here. CPU tensors take
    ``packed_combine_plain``."""
    _check_stacked(car, x, (2,), "packed_combine_fwd")
    if x.device.type == "cpu":
        return packed_combine_plain(car, x, v, w1, b1, w2)
    carp, ptrs, x, v, w1, b1, w2 = _packed_operands(car, x, v, w1, b1, w2, "packed_combine_fwd")
    y = launch_forward(PACKED, ptrs, carp.shape[1], x, v, w1, b1, w2)
    packed_combine_fwd.launches += 1
    return y


packed_combine_fwd.launches = 0


def packed_combine_bwd(car, x, v, w1, b1, w2, dy):
    """Row 9: the packed backward -> (dcar [2, P, C], dx, dv, dw1, db1,
    dw2). The kernel writes dcar in the packed [P, 2C] layout; dcar is its
    [2, P, C] view. CPU tensors take ``packed_combine_bwd_plain``."""
    _check_stacked(car, x, (2,), "packed_combine_bwd")
    if x.device.type == "cpu":
        return packed_combine_bwd_plain(car, x, v, w1, b1, w2, dy)
    carp, ptrs, x, v, w1, b1, w2 = _packed_operands(car, x, v, w1, b1, w2, "packed_combine_bwd")
    dy = dy.to(x.dtype).contiguous()
    p, c = x.shape
    dcarp = torch.empty_like(carp)
    dcar_ptrs = [dcarp.data_ptr(), dcarp.data_ptr() + c * dcarp.element_size()]
    grads = launch_backward(PACKED, ptrs, 2 * c, x, v, w1, b1, w2, dy, dcar_ptrs, 2 * c)
    packed_combine_bwd.launches += 1
    return (dcarp.view(p, 2, c).transpose(0, 1), *grads)


packed_combine_bwd.launches = 0


class PackedCombine(torch.autograd.Function):
    """``packed_combine_fwd`` forward, ``packed_combine_bwd`` backward."""

    @staticmethod
    def forward(ctx, car, x, v, w1, b1, w2):
        ctx.save_for_backward(car, x, v, w1, b1, w2)
        return packed_combine_fwd(car, x, v, w1, b1, w2)

    @staticmethod
    def backward(ctx, dy):
        return packed_combine_bwd(*ctx.saved_tensors, dy.contiguous())


def packed_combine(car, x, v, w1, b1, w2):
    """The packed combine, differentiable in every input."""
    return PackedCombine.apply(car, x, v, w1, b1, w2)


# ---------------------------------------------------------- ablations


def combine_copy_plain(car, x):
    """y = x + car_0 + ... + car_{M-1}."""
    y = x
    for c in car:
        y = y + c
    return y


def combine_matmul_plain(car, x, v):
    """y = sum_m (car_m V_m + x): the channel mixes alone."""
    y = torch.zeros_like(x)
    for i, c in enumerate(car):
        y = y + (c @ v[i] + x)
    return y


def combine_nogelu_plain(car, x, v, w1, b1, w2):
    """The full combine with the identity in place of gelu."""
    return _combine(tuple(car), x, v, w1, b1, w2, lambda h: h)


def _ablation(mode, wrapper, plain, car, x, *weights):
    """``plain(car, x, *weights)`` for CPU tensors; else one launch of the
    kernel in ``mode``, counted on ``wrapper``."""
    name = wrapper.__name__
    _check_stacked(car, x, (1, 2, 3), name)
    if x.device.type == "cpu":
        return plain(car, x, *weights)
    car, x = car.contiguous(), x.contiguous()
    weights = [t.contiguous() for t in weights]
    check_cuda([x, car, *weights], name)
    y = launch_forward(mode, [car[m].data_ptr() for m in range(car.shape[0])], x.shape[-1], x, *weights)
    wrapper.launches += 1
    return y


def combine_copy(car, x):
    """Row 10, copy: the launch and data-movement floor of the ladder."""
    return _ablation(COPY, combine_copy, combine_copy_plain, car, x)


combine_copy.launches = 0


def combine_matmul(car, x, v):
    """Row 10, matmul: the two channel mixes without the attention MLP."""
    return _ablation(MATMUL, combine_matmul, combine_matmul_plain, car, x, v)


combine_matmul.launches = 0


def combine_nogelu(car, x, v, w1, b1, w2):
    """Row 10, nogelu: the full forward with the identity for gelu."""
    return _ablation(NOGELU, combine_nogelu, combine_nogelu_plain, car, x, v, w1, b1, w2)


combine_nogelu.launches = 0
