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
# The kernels split the rows among their blocks in units of this many rows.
ROW_UNIT = 32


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


def combine_row_ranges(rows: int, blocks: int) -> list:
    """The [start, end) rows that each of ``blocks`` blocks of the CUDA
    kernels owns, in block order, with the kernels' integer arithmetic: the
    ``ceil(rows / ROW_UNIT)`` units of 32 rows split into contiguous ranges
    whose sizes differ by at most one unit (empty where blocks outnumber
    units); the last range ends at ``rows``."""
    units = -(-rows // ROW_UNIT)
    edges = [min(b * units // blocks * ROW_UNIT, rows) for b in range(blocks + 1)]
    return list(zip(edges[:-1], edges[1:]))


def combine_bwd_blocked_plain(carriers, x, v, w1, b1, w2, dy, blocks: int) -> tuple:
    """``combine_bwd_plain`` with the backward kernel's cross-block sum: dV,
    dW1, db1 and dw2 computed in fp32 over each of ``combine_row_ranges``'
    ranges and summed in block order (the kernel's second pass), then cast
    to the input type; dcarriers and dx per row, as ``combine_bwd_plain``."""
    c = x.shape[-1]
    dcar, dx, *_ = combine_bwd_plain(carriers, x, v, w1, b1, w2, dy)
    rows = [t.reshape(-1, c).float() for t in (*carriers, x, dy)]
    weights = [t.float() for t in (v, w1, b1, w2)]
    m = len(carriers)
    total = None
    for start, end in combine_row_ranges(rows[0].shape[0], blocks):
        if start == end:
            continue
        part = [t[start:end] for t in rows]
        _, _, *grads = combine_bwd_plain(tuple(part[:m]), part[m], *weights, part[m + 1])
        total = grads if total is None else [a + g for a, g in zip(total, grads)]
    return (dcar, dx, *(t.to(x.dtype) for t in total))


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


def _operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and starting on 16 bytes, as the kernels' vector
    loads need (a copy only where a view starts elsewhere)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


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
        "sccn_combine_fwd_blocks": [i64, i32, i32, i32],
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


def kernel_blocks(rows: int, m: int, dtype, mode: int = FULL, backward: bool = False) -> int:
    """How many blocks the forward (or backward) kernel launches for
    ``rows`` rows of M messages in ``dtype``: as many as fit on the card at
    once, at most one per 32-row unit. Builds the kernels on first use."""
    name = "sccn_combine_bwd_blocks" if backward else "sccn_combine_fwd_blocks"
    blocks = _kernels()[name](rows, m, _DTYPE_CODES[dtype], mode)
    if blocks <= 0:
        raise RuntimeError(f"{name} (mode {mode}, M={m}, rows={rows}) refused: CUDA error {-blocks}")
    return blocks


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
    blocks = kernel_blocks(rows, m, x.dtype, mode, backward=True)
    elems = m * c * c + c * c + 2 * c
    partials = torch.empty((blocks, elems), dtype=torch.float32, device=x.device)
    wgrad = torch.empty(elems, dtype=x.dtype, device=x.device)
    dx = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernels()["sccn_combine_bwd"](
            *_padded(car_ptrs), car_stride, x.data_ptr(), v.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), dy.data_ptr(), *_padded(dcar_ptrs), dcar_stride, dx.data_ptr(),
            partials.data_ptr(), blocks, wgrad.data_ptr(), rows, m, _DTYPE_CODES[x.dtype], mode, stream,
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
    cars = [_operand(t) for t in carriers]
    x, v, w1, b1, w2 = (_operand(t) for t in (x, v, w1, b1, w2))
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
    cars = [_operand(t) for t in carriers]
    x, v, w1, b1, w2 = (_operand(t) for t in (x, v, w1, b1, w2))
    dy = _operand(dy.to(x.dtype))
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
