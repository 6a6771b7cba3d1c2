"""SCCN message combine: the plain torch version and the wrappers of the
hand-written CUDA forward and backward kernels (``csrc/sccn_combine.cu``).

Port of ``topo_audio_autoencoder_tpu.ops.sccn_combine``. Per rank, an SCCN
layer turns up to three message carriers into one output:

    msg_m  = carrier_m @ V_m + x          (channel mix + residual)
    h_m    = gelu_tanh(msg_m @ W1 + b1)
    s_m    = h_m @ w2                      (attention score)
    attn   = softmax_m(s)                  (in fp32)
    y      = sum_m attn_m * msg_m

``message_combine_reference`` is the plain version. ``combine_fwd`` and
``combine_bwd`` take it (and autograd through it) for CPU tensors and
launch the kernels for CUDA tensors, each counting its launches in
``launches``; they never fall back from one to the other.
``fused_message_combine`` ties them into one autograd Function, the same on
both devices; ``GradientSCCNLayer(fused_combine=True)`` takes it for ranks
of at least ``MIN_FUSED_ROWS`` rows. The per-message scales stay folded
into ``V`` outside the op (``V_m = W_m * scale_m``), so autograd through
that product recovers dW and dscale from dV.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache

import torch

_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)
_GELU_C = 0.044715

# Below this many rows (B * S_r) a rank stays on the plain composition, as
# in the JAX package: ranks 0 and 1 of the n=20 complex (20 and 190
# simplices per clip) never reach it.
MIN_FUSED_ROWS = 4096
# The one channel width the kernels are built for (the flagship's).
KERNEL_CHANNELS = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The kernels' variants (csrc/sccn_combine.cu's Mode).
FULL, PACKED, NOGELU, MATMUL, COPY = range(5)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate gelu, the same formula as jax.nn.gelu(approximate=True)."""
    u = _SQRT_2_OVER_PI * (x + _GELU_C * x * x * x)
    return 0.5 * x * (1.0 + torch.tanh(u))


def _combine(carriers, x, v, w1, b1, w2, activation):
    msgs = torch.stack([c @ v[i] + x for i, c in enumerate(carriers)])
    h = activation(msgs @ w1 + b1)
    scores = (h @ w2).to(torch.float32)  # [M, B, S, 1]
    attn = torch.softmax(scores, dim=0).to(msgs.dtype)
    return (msgs * attn).sum(dim=0)


def message_combine_reference(carriers, x, v, w1, b1, w2):
    """carriers: tuple of M [B, S, C] tensors, x [B, S, C], v [M, C, C],
    w1 [C, C], b1 [C], w2 [C, 1] -> [B, S, C]."""
    return _combine(carriers, x, v, w1, b1, w2, _gelu)


def vjp_plain(fn, inputs, dy) -> tuple:
    """The gradients of ``fn(*inputs)`` against ``dy``, by autograd (also
    where grad mode is off, as inside a backward), each in its input's
    dtype."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        return torch.autograd.grad(fn(*leaves), leaves, dy)


def combine_bwd_plain(carriers, x, v, w1, b1, w2, dy):
    """The backward of ``message_combine_reference`` -> (dcarriers tuple,
    dx, dv, dw1, db1, dw2)."""
    m = len(carriers)
    grads = vjp_plain(lambda *t: message_combine_reference(t[:m], *t[m:]), (*carriers, x, v, w1, b1, w2), dy)
    return (tuple(grads[:m]), *grads[m:])


def _check(carriers, x, v, w1, b1, w2, what: str) -> None:
    m = len(carriers)
    if not 1 <= m <= 3:
        raise ValueError(f"{what} takes 1 to 3 carriers, not {m}")
    if x.dim() < 2:
        raise ValueError(f"{what}: x must be [..., C], not {tuple(x.shape)}")
    c = x.shape[-1]
    for car in carriers:
        if car.shape != x.shape:
            raise ValueError(f"{what}: carrier {tuple(car.shape)} does not match x {tuple(x.shape)}")
    shapes = {"v": (v, (m, c, c)), "w1": (w1, (c, c)), "b1": (b1, (c,)), "w2": (w2, (c, 1))}
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"{what}: {name} {tuple(t.shape)} must be {want}")
    devices = {t.device for t in (*carriers, x, v, w1, b1, w2)}
    if len(devices) != 1:
        raise ValueError(f"{what}: inputs lie on several devices: {devices}")
    device = x.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda tensors, not {device}")


def check_cuda(tensors, what: str) -> None:
    """What every kernel of csrc/sccn_combine.cu takes: one dtype of fp32 or
    bf16 for all operands, C = KERNEL_CHANNELS, at least one row."""
    x = tensors[0]
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1 or x.dtype not in _DTYPE_CODES:
        raise TypeError(f"the {what} kernel takes float32 or bfloat16 operands of one dtype, not {dtypes}")
    if x.shape[-1] != KERNEL_CHANNELS:
        raise ValueError(f"the {what} kernel is built for C={KERNEL_CHANNELS}, not C={x.shape[-1]}")
    if x.numel() == 0:
        raise ValueError(f"the {what} kernel takes at least one row")


@lru_cache(maxsize=None)
def _kernels():
    """The C entry points of csrc/sccn_combine.cu, built on first use."""
    from ..cuda_build import load

    lib = load("sccn_combine")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    signatures = {
        "sccn_combine_fwd": [ptr] * 3 + [i64] + [ptr] * 6 + [i64, i32, i32, i32, ptr],
        "sccn_combine_bwd_blocks": [i64, i32, i32, i32],
        "sccn_combine_bwd": [ptr] * 3 + [i64] + [ptr] * 9 + [i64, ptr, ptr, i32, ptr, i64, i32, i32, i32, ptr],
    }
    fns = {}
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _ptr(t):
    return None if t is None else t.data_ptr()


def _padded(ptrs) -> list:
    return list(ptrs) + [None] * (3 - len(ptrs))


def launch_forward(mode: int, car_ptrs, car_stride: int, x, v=None, w1=None, b1=None, w2=None):
    """One launch of the forward kernel in ``mode`` on the current stream.

    ``car_ptrs``: the M carriers' data pointers, rows ``car_stride``
    elements apart; x, v, w1, b1, w2 contiguous CUDA tensors of one checked
    dtype (the weights a mode does not read may be None). Returns y, shaped
    and typed as x. Raises if the launch is refused."""
    rows = x.numel() // x.shape[-1]
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernels()["sccn_combine_fwd"](
            *_padded(car_ptrs), car_stride, x.data_ptr(), _ptr(v), _ptr(w1), _ptr(b1), _ptr(w2),
            y.data_ptr(), rows, len(car_ptrs), _DTYPE_CODES[x.dtype], mode, stream,
        )
    if err != 0:
        raise RuntimeError(f"sccn_combine_fwd (mode {mode}) launch failed: CUDA error {err}")
    return y


def launch_backward(mode: int, car_ptrs, car_stride: int, x, v, w1, b1, w2, dy, dcar_ptrs, dcar_stride: int):
    """One launch of the backward kernel and its reduction in ``mode``.

    Writes the carriers' gradients through ``dcar_ptrs`` (rows
    ``dcar_stride`` elements apart, allocated by the caller) and returns
    (dx, dv, dw1, db1, dw2) in x's dtype; the four weight gradients are
    views of one buffer."""
    m, c = len(car_ptrs), x.shape[-1]
    rows = x.numel() // c
    code = _DTYPE_CODES[x.dtype]
    fns = _kernels()
    blocks = fns["sccn_combine_bwd_blocks"](rows, m, code, mode)
    if blocks <= 0:
        raise RuntimeError(f"sccn_combine_bwd (mode {mode}) refused: CUDA error {-blocks}")
    elems = m * c * c + c * c + 2 * c
    partials = torch.empty((blocks, elems), dtype=torch.float32, device=x.device)
    wgrad = torch.empty(elems, dtype=x.dtype, device=x.device)
    dx = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fns["sccn_combine_bwd"](
            *_padded(car_ptrs), car_stride, x.data_ptr(), v.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), dy.data_ptr(), *_padded(dcar_ptrs), dcar_stride, dx.data_ptr(),
            partials.data_ptr(), blocks, wgrad.data_ptr(), rows, m, code, mode, stream,
        )
    if err != 0:
        raise RuntimeError(f"sccn_combine_bwd (mode {mode}) launch failed: CUDA error {err}")
    dv, dw1, db1, dw2 = torch.split(wgrad, [m * c * c, c * c, c, c])
    return dx, dv.view(m, c, c), dw1.view(c, c), db1, dw2.view(c, 1)


def combine_fwd(carriers, x, v, w1, b1, w2):
    """The combine's forward -> y [..., C] (row 6 of the kernel table).

    CPU tensors take ``message_combine_reference``; CUDA tensors launch the
    kernel (``launches`` counts those launches); any other device raises."""
    _check(carriers, x, v, w1, b1, w2, "combine_fwd")
    if x.device.type == "cpu":
        return message_combine_reference(carriers, x, v, w1, b1, w2)
    cars = [t.contiguous() for t in carriers]
    x, v, w1, b1, w2 = (t.contiguous() for t in (x, v, w1, b1, w2))
    check_cuda([x, *cars, v, w1, b1, w2], "combine_fwd")
    y = launch_forward(FULL, [t.data_ptr() for t in cars], x.shape[-1], x, v, w1, b1, w2)
    combine_fwd.launches += 1
    return y


combine_fwd.launches = 0


def combine_bwd(carriers, x, v, w1, b1, w2, dy):
    """The combine's backward from the forward's inputs and dy -> (dcarriers
    tuple, dx, dv, dw1, db1, dw2), each in its input's dtype (row 7).

    CPU tensors take ``combine_bwd_plain``; CUDA tensors launch the kernel
    and its reduction (``launches`` counts those launches); any other device
    raises."""
    _check(carriers, x, v, w1, b1, w2, "combine_bwd")
    if dy.shape != x.shape or dy.device != x.device:
        raise ValueError(f"combine_bwd: dy {tuple(dy.shape)} must match x {tuple(x.shape)}")
    if x.device.type == "cpu":
        return combine_bwd_plain(carriers, x, v, w1, b1, w2, dy)
    cars = [t.contiguous() for t in carriers]
    x, v, w1, b1, w2 = (t.contiguous() for t in (x, v, w1, b1, w2))
    dy = dy.to(x.dtype).contiguous()
    check_cuda([x, *cars, v, w1, b1, w2, dy], "combine_bwd")
    dcar = tuple(torch.empty_like(x) for _ in cars)
    c = x.shape[-1]
    grads = launch_backward(FULL, [t.data_ptr() for t in cars], c, x, v, w1, b1, w2, dy,
                            [t.data_ptr() for t in dcar], c)
    combine_bwd.launches += 1
    return (dcar, *grads)


combine_bwd.launches = 0


class FusedMessageCombine(torch.autograd.Function):
    """``combine_fwd`` forward, ``combine_bwd`` backward, which recomputes the
    forward from the saved inputs (no activation is kept). The carriers come
    last, as separate tensors: stacking them would cost a copy."""

    @staticmethod
    def forward(ctx, x, v, w1, b1, w2, *carriers):
        ctx.save_for_backward(x, v, w1, b1, w2, *carriers)
        return combine_fwd(carriers, x, v, w1, b1, w2)

    @staticmethod
    def backward(ctx, dy):
        x, v, w1, b1, w2, *carriers = ctx.saved_tensors
        dcar, dx, dv, dw1, db1, dw2 = combine_bwd(tuple(carriers), x, v, w1, b1, w2, dy.contiguous())
        return (dx, dv, dw1, db1, dw2, *dcar)


def fused_message_combine(carriers, x, v, w1, b1, w2):
    """Fused message mix + attention combine; the arguments and the result
    of ``message_combine_reference``. Differentiable in every input."""
    return FusedMessageCombine.apply(x, v, w1, b1, w2, *carriers)
