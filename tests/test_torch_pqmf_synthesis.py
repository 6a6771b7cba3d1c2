"""The PQMF synthesis as a polyphase product (``ops/pqmf.py``): the tap
table and the kernels' plain versions against the transposed conv and its
autograd, the autograd Function and its vmap rule, the CPU path of
``PQMF.inverse`` unchanged, the shapes the kernels refuse, the spans and
the counter, and the metric that reads them. No JAX: the tests marked
``gpu`` hold the kernels (``csrc/pqmf_synthesis.cu``) against cuDNN and
the fp64 host synthesis on the card, and skip without one.

Run on the card with ``python -m pytest --noconftest tests/test_torch_pqmf_synthesis.py -q``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from scipy import signal as sps

from topo_audio_autoencoder_torch.ops import pqmf
from topo_audio_autoencoder_torch.utils import profiling

torch.set_num_threads(1)

# (bands, attenuation): the flagship's filterbank and three others, one of
# an odd band count.
BANKS = [(16, 100.0), (4, 100.0), (8, 80.0), (3, 100.0)]
BANK_IDS = ["m16", "m4", "m8_a80", "m3"]
# Frames: one, two, and a count that is a multiple of no kernel tile.
LENGTHS = [1, 2, 37]
B = 3
# fp32 on both sides, in other orders of summation.
TOL_FP32 = dict(rtol=1e-5, atol=1e-5)


def _bank(m, attenuation):
    return pqmf.PQMF(attenuation, m)


def _parent_inverse(bank, z):
    """``PQMF.inverse`` as it was before the kernels: the transposed conv,
    the crop and the scale."""
    m, n = bank.n_band, bank.taps
    pad = n // 2
    y = F.conv_transpose1d(z, bank.filters.to(z.dtype), stride=m)
    return y[..., pad : pad + z.shape[-1] * m] * float(m)


def _frames(m, length, layout, dtype=torch.float32, seed=0, device="cpu"):
    """Frames [B, L, M]: contiguous, or the transposed view of a contiguous
    [B, M, L]."""
    gen = torch.Generator().manual_seed(seed)
    if layout == "contiguous":
        x = torch.randn(B, length, m, generator=gen)
    else:
        x = torch.randn(B, m, length, generator=gen).transpose(1, 2)
    return x.to(device, dtype)


def _plain(bank, dtype=torch.float32):
    return pqmf.synthesis_table(bank.filters, dtype), pqmf.synthesis_offsets(bank.n_band, bank.taps)[1]


@pytest.mark.parametrize("layout", ["contiguous", "transposed"])
@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("m,attenuation", BANKS, ids=BANK_IDS)
def test_polyphase_equals_the_transposed_conv(m, attenuation, length, layout):
    """The host table and the plain polyphase sum over shifted frames give
    the transposed conv, cropped and scaled by M, within fp32 rounding."""
    bank = _bank(m, attenuation)
    table, shift = _plain(bank)
    assert table.dtype == torch.float32 and table.shape[1:] == (m, m) and table.shape[0] % pqmf.CHUNK == 0
    frames = _frames(m, length, layout)
    got = pqmf.synthesis(frames, table, shift)
    want = _parent_inverse(bank, frames.transpose(1, 2))
    assert got.shape == (B, length, m)
    torch.testing.assert_close(got.reshape(B, 1, -1), want, **TOL_FP32)


@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("m,attenuation", BANKS, ids=BANK_IDS)
def test_adjoint_equals_autograd_through_the_conv(m, attenuation, length):
    """The plain adjoint is autograd's gradient through the transposed
    conv, and the Function's backward is the adjoint (fp64 gradcheck)."""
    bank = _bank(m, attenuation)
    table, shift = _plain(bank)
    z = _frames(m, length, "transposed", seed=1).transpose(1, 2).requires_grad_()
    grad = torch.randn(B, 1, length * m, generator=torch.Generator().manual_seed(2))
    (want,) = torch.autograd.grad(_parent_inverse(bank, z), z, grad)
    got = pqmf.synthesis_adjoint(grad.reshape(B, length, m), table, shift)
    torch.testing.assert_close(got, want.transpose(1, 2), **TOL_FP32)
    frames = torch.randn(2, length, m, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda x: pqmf.PQMFSynthesis.apply(x, table.double(), shift), (frames,))


@pytest.mark.parametrize("layout", ["contiguous", "transposed"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_cpu_inverse_is_the_parents_bit_for_bit(dtype, layout):
    """On the CPU ``PQMF.inverse`` is the transposed conv, unchanged, and
    counts no kernel call."""
    bank = _bank(16, 100.0)
    z = _frames(16, 37, layout, dtype, seed=3).transpose(1, 2)
    profiling.reset_spans()
    assert torch.equal(bank.inverse(z), _parent_inverse(bank, z))
    assert profiling.span_summary()["counters"] == {}


def test_table_rounds_the_taps_as_the_conv_does():
    """The table holds the filters rounded to the input's type, each tap
    once; rows past the taps are zero."""
    bank = _bank(16, 100.0)
    table = pqmf.synthesis_table(bank.filters, torch.bfloat16)
    taps = bank.filters.reshape(16, -1).to(torch.bfloat16).float()
    assert torch.equal(table.to(torch.bfloat16).float(), table)
    assert torch.equal(torch.sort(table[table != 0]).values, torch.sort(taps[taps != 0]).values)


def test_kernel_table_built_once_outside_inference_mode():
    """The module keeps one table per (type, device); one first built
    under the codec's ``torch.inference_mode`` is a normal tensor, which a
    later training step may save for its backward."""
    bank = _bank(4, 100.0)
    with torch.inference_mode():
        table = bank.kernel_table(torch.bfloat16, "cpu")
    assert not table.is_inference() and not table.requires_grad
    assert bank.kernel_table(torch.bfloat16, torch.device("cpu")) is table
    assert torch.equal(table, pqmf.synthesis_table(bank.filters, torch.bfloat16))
    assert bank.kernel_table(torch.float32, "cpu") is not table


def _designed_taps(bands, attenuation=100.0):
    """The tap count ``PQMF(attenuation, bands)`` designs."""
    return sps.kaiserord(attenuation, 1.0 / (2.0 * bands))[0] | 1


@pytest.mark.parametrize("bands,taps,dtype,what", [
    (64, _designed_taps(64), torch.bfloat16, "shared memory"),
    (16, 413, torch.float16, "float32 or bfloat16"),
    (16, 2901, torch.float32, "shared memory"),
], ids=["m64", "fp16", "m16_n2901"])
def test_kernel_check_refuses_what_the_kernels_cannot_take(bands, taps, dtype, what):
    """64 bands at attenuation 100 (1,643 taps, 28 offsets: a 458,752-byte
    table), fp16, and 16 bands of 2,901 taps (184 offsets: 244,736 bytes a
    block)."""
    offsets, _ = pqmf.synthesis_offsets(bands, taps)
    with pytest.raises(ValueError, match=what):
        pqmf.check_synthesis_kernel(bands, offsets, dtype)


@pytest.mark.parametrize("bands", [1, 2, 3, 4, 5, 6, 8, 12, 16, 24, 32])
def test_kernel_check_takes_every_band_count_whose_block_fits(bands):
    """Every band count up to 32 at attenuation 100 fits a block, in both
    types; the flagship's 16 bands take 65,024 bytes."""
    offsets, shift = pqmf.synthesis_offsets(bands, _designed_taps(bands))
    assert pqmf.synthesis_shared_bytes(bands, offsets) <= pqmf.MAX_SHARED_BYTES
    for dtype in (torch.float32, torch.bfloat16):
        pqmf.check_synthesis_kernel(bands, offsets, dtype)
    if bands == 16:
        assert (_designed_taps(16), offsets, shift) == (413, 28, 13)
        assert pqmf.synthesis_shared_bytes(16, offsets) == 65_024


def test_other_devices_raise():
    bank = _bank(4, 100.0)
    table, shift = _plain(bank)
    for fn in (pqmf.synthesis, pqmf.synthesis_adjoint):
        with pytest.raises(ValueError, match="cpu or cuda"):
            fn(torch.zeros(1, 3, 4, device="meta"), table, shift)


def test_backward_span_recorded_and_counter_kernel_path_only():
    """Under a profiler the Function's backward is the span
    ``taa.pqmf.synthesis_bwd``; ``pqmf.synthesis_kernel`` stays 0 on the
    CPU, where ``inverse`` takes the transposed conv."""
    bank = _bank(4, 100.0)
    table, shift = _plain(bank)
    frames = _frames(4, 37, "contiguous").requires_grad_()
    profiling.reset_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        pqmf.PQMFSynthesis.apply(frames, table, shift).sum().backward()
        bank.inverse(frames.detach().transpose(1, 2))
    summary = profiling.span_summary()
    assert summary["spans"]["taa.pqmf.synthesis_bwd"]["count"] == 1
    assert summary["spans"]["taa.pqmf.synthesis_bwd"]["device_s"] is None
    assert summary["spans"]["taa.pqmf.synthesis"]["count"] == 1
    assert summary["counters"].get("pqmf.synthesis_kernel", 0) == 0


def test_vmap_folds_into_the_batch():
    """Under ``torch.func.vmap`` the Function runs once over K*B frames and
    gives each element's synthesis and gradient."""
    bank = _bank(4, 100.0)
    table, shift = _plain(bank)
    x = torch.randn(2, B, 9, 4, generator=torch.Generator().manual_seed(4), requires_grad=True)
    y = torch.func.vmap(lambda f: pqmf.PQMFSynthesis.apply(f, table, shift))(x)
    for k in range(2):
        torch.testing.assert_close(y[k], pqmf.synthesis_plain(x[k], table, shift), **TOL_FP32)
    grad = torch.randn_like(y)
    (got,) = torch.autograd.grad(y, x, grad)
    for k in range(2):
        torch.testing.assert_close(got[k], pqmf.synthesis_adjoint_plain(grad[k], table, shift), **TOL_FP32)


def _metric():
    from portbench import harness

    return harness.metric_reader("pqmf_synthesis_device_ms.train")


@pytest.mark.parametrize("spans,want", [
    ({}, None),
    ({"taa.train.step": {"count": 2, "device_s": None}, "taa.pqmf.synthesis": {"count": 2, "device_s": None}}, None),
    ({"taa.train.step": {"count": 2, "device_s": None}, "taa.pqmf.synthesis": {"count": 2, "device_s": 0.004},
      "taa.pqmf.synthesis_bwd": {"count": 2, "device_s": 0.002}}, 3.0),
], ids=["no_spans", "no_events", "events"])
def test_metric_reads_the_two_spans_events_a_step(monkeypatch, spans, want):
    monkeypatch.setattr(profiling, "span_summary", lambda: {"spans": spans, "counters": {}})
    got = _metric()(None)
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want)


# ---------------------------------------------------------------- the card

# The train step's synthesis: 128 clips of 4,000 frames of 16 bands.
CELL = (128, 4000, 16)
# Clips of the cell's batch held against the fp64 host synthesis.
FP64_CLIPS = 4
# fp32: the kernel and cuDNN (TF32 off) differ in their order of summation.
TOL_CUDNN_FP32 = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel_l2(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def _errors(got, want):
    err = (got.double().cpu() - want).abs()
    return float(err.max()), float(err.mean())


def _fp64_synthesis(bank, z, dtype):
    """The fp64 host synthesis (``_np_synthesis``) of the first clips of
    z [B, M, L], from the filters rounded to ``dtype``."""
    hk = bank.filters.cpu().reshape(bank.n_band, -1).to(dtype).double().numpy()
    zs = z[:FP64_CLIPS].double().cpu().numpy()
    return torch.from_numpy(np.stack([pqmf._np_synthesis(c, hk, bank.n_band) for c in zs]))[:, None]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_card_synthesis_against_cudnn_and_fp64(cuda, dtype):
    """At the cell's shape: the kernel's error against the fp64 host
    synthesis is no larger than cuDNN's on the same inputs, fp32 within
    TOL_CUDNN_FP32 relative L2 of cuDNN, two calls bit for bit."""
    b, length, m = CELL
    bank = _bank(m, 100.0).to(cuda)
    sub = torch.randn(b, length, m, generator=torch.Generator().manual_seed(5)).to(cuda, dtype)
    z = sub.transpose(1, 2)
    before = pqmf.synthesis.launches
    got = bank.inverse(z)
    again = bank.inverse(z)
    library = _parent_inverse(bank, z)
    torch.cuda.synchronize()
    assert pqmf.synthesis.launches == before + 2
    assert got.shape == (b, 1, length * m) and got.dtype == dtype
    assert torch.equal(got, again)
    exact = _fp64_synthesis(bank, z, dtype)
    kernel_err, library_err = _errors(got[:FP64_CLIPS], exact), _errors(library[:FP64_CLIPS], exact)
    assert kernel_err[0] <= library_err[0] and kernel_err[1] <= library_err[1], (kernel_err, library_err)
    if dtype == torch.float32:
        assert _rel_l2(got, library) <= TOL_CUDNN_FP32


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_card_adjoint_against_cudnn_and_fp64(cuda, dtype):
    """The backward at the cell's shape against autograd through cuDNN's
    transposed conv and the fp64 gradient of the first clips on the host."""
    b, length, m = CELL
    bank = _bank(m, 100.0).to(cuda)
    gen = torch.Generator().manual_seed(6)
    sub = torch.randn(b, length, m, generator=gen).to(cuda, dtype).requires_grad_()
    grad = torch.randn(b, 1, length * m, generator=gen).to(cuda, dtype)
    before = pqmf.synthesis_adjoint.launches
    (got,) = torch.autograd.grad(bank.inverse(sub.transpose(1, 2)), sub, grad)
    (again,) = torch.autograd.grad(bank.inverse(sub.transpose(1, 2)), sub, grad)
    (library,) = torch.autograd.grad(_parent_inverse(bank, sub.transpose(1, 2)), sub, grad)
    torch.cuda.synchronize()
    assert pqmf.synthesis_adjoint.launches == before + 2
    assert got.shape == sub.shape and got.dtype == dtype and torch.equal(got, again)
    host = _bank(m, 100.0).double()
    host.filters = bank.filters.cpu().to(dtype).double()
    z = sub[:FP64_CLIPS].detach().cpu().double().transpose(1, 2).requires_grad_()
    (exact,) = torch.autograd.grad(_parent_inverse(host, z), z, grad[:FP64_CLIPS].cpu().double())
    exact = exact.transpose(1, 2)
    kernel_err, library_err = _errors(got[:FP64_CLIPS], exact), _errors(library[:FP64_CLIPS], exact)
    assert kernel_err[0] <= library_err[0] and kernel_err[1] <= library_err[1], (kernel_err, library_err)
    if dtype == torch.float32:
        assert _rel_l2(got, library) <= TOL_CUDNN_FP32


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("length", [1, 2, 37, 257, 1000])
@pytest.mark.parametrize("m,attenuation", BANKS + [(2, 100.0), (1, 100.0), (12, 100.0), (32, 100.0)],
                         ids=BANK_IDS + ["m2", "m1", "m12", "m32"])
def test_card_kernels_round_the_exact_sums_once(cuda, m, attenuation, length, dtype):
    """Short clips, one clip, ragged tiles, and band counts of each
    thread tiling (4, 2 and 1 outputs a thread) up to 32, through
    ``inverse`` and its backward: each output is the plain versions'
    sum in fp64 of the same inputs, rounded once to the type (within one
    half spacing, and a little for the fp64 sums' own order)."""
    bank = _bank(m, attenuation).to(cuda)
    table, shift = bank.kernel_table(dtype, cuda).double(), pqmf.synthesis_offsets(m, bank.taps)[1]
    half = 2.0 ** -24 if dtype == torch.float32 else 2.0 ** -8
    for batch in (1, B):
        gen = torch.Generator().manual_seed(length)
        sub = torch.randn(batch, length, m, generator=gen).to(cuda, dtype).requires_grad_()
        y = bank.inverse(sub.transpose(1, 2))
        grad = torch.randn(y.shape, generator=gen).to(cuda, dtype)
        (got,) = torch.autograd.grad(y, sub, grad)
        want_y = pqmf.synthesis_plain(sub.detach().double(), table, shift)
        want_g = pqmf.synthesis_adjoint_plain(grad.double().reshape(batch, length, m), table, shift)
        for out, want in ((y.reshape(batch, length, m), want_y), (got, want_g)):
            assert out.dtype == dtype
            torch.testing.assert_close(out.double(), want, rtol=half * 1.0001, atol=1e-12)


@pytest.mark.gpu
def test_card_refuses_a_filterbank_over_shared_memory(cuda):
    bank = _bank(16, 100.0).to(cuda)
    bank.filters = torch.randn(16, 1, 2901, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        bank.inverse(torch.zeros(1, 16, 8, device=cuda))


@pytest.mark.gpu
def test_card_spans_and_counter(cuda):
    """On the card the synthesis and its backward record their events, and
    ``pqmf.synthesis_kernel`` counts each synthesis."""
    bank = _bank(16, 100.0).to(cuda)
    sub = torch.randn(2, 64, 16, device=cuda, requires_grad=True)
    profiling.reset_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        bank.inverse(sub.transpose(1, 2)).sum().backward()
        torch.cuda.synchronize()
    summary = profiling.span_summary()
    assert summary["counters"]["pqmf.synthesis_kernel"] == 1
    for name in ("taa.pqmf.synthesis", "taa.pqmf.synthesis_bwd"):
        assert summary["spans"][name]["count"] == 1 and summary["spans"][name]["device_s"] > 0.0

