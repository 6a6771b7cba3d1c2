#!/usr/bin/env python3
"""Drive the PyTorch port's codec and train step on one CUDA card and hold
its kernels against their plain versions.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card (an H100:
the kernels are built for sm_90a). Phases, one JSON line each:

1. env      the card (nvidia-smi name and power limit), versions, the
            kernels' build (all sources compiled at once, one nvcc each).
2. kernel   each CUDA kernel against its plain torch version on the card,
            on synthetic inputs at its main-path shape, in fp32 and bf16,
            with times (CUDA events, median of 30 after warm-up) for the
            kernel, the plain version and one PyTorch library call where
            one computes the same function, and the bound: the attention
            forward at the codec's shape, the attention backward at the
            train step's, the binary-Gumbel sampler at the train step's
            logits (and its generator's statistics over 4M draws).
3. serve    the flagship-width codec (n=20, 16 bands, C=64, 6 SCCN
            layers, seeded random weights): a warm-up request and three
            timed ones of 8 clips x 64,000 samples, each encode -> pack ->
            unpack -> decode plus one reconstruct. Launch counters are
            zeroed just before and read just after.
   kernel   again, on the attention inputs of one more main-path decode.
4. trace    one decode under torch.profiler: device busy share, top ops.
5. parity   the card's weights copied to a CPU model; the plain path's
            logits, latent and waveform against the card's.
6. train    the flagship train step (fp32, B=16 anchors x G=3 clips of
            64,000 samples, two-group Adam, clipping): one warm-up and 10
            timed steps, launch counters zeroed just before and read just
            after; then 3 bf16 steps.
   kernel   the attention forward and backward on the inputs (and the
            output gradient) captured from one more train step.
   trace    one train step under torch.profiler.
7. train_parity  one step's loss and gradients on the card against the
            CPU plain path on the same weights and uniforms (B=2, G=3).
8. kernels  one line per kernel: route, source, launches (train step),
            error, times (from the train step's inputs).

Then the nvidia-smi line and, last, {"ok": true, "device": ...}. Any failed
check exits non-zero before the last line. Without a card it exits 2.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 511990
DEVICE = "cuda"
FLAGSHIP = dict(num_vertices=20, num_bands=16, sccn_hidden_dim=64, n_sccn_layers=6)
NUM_SAMPLES = 64000
CLIPS = 8
REQUESTS = 3
# Attention at the codec's shape: B=8 clips, Q=250 queries, M=190+1140+4845
# rank 1-3 keys, C=64 channels in H=4 heads of D=16.
ATTN = dict(b=8, q=250, m=6175, c=64, h=4)
# Stated tolerances. Kernel vs plain, fp32: both sum in fp32 and differ in
# order only. bf16: both round one fp32 output to bf16, at most one ulp
# apart (2^-7 at |o| < 1, 2^-6 below 2). L (log-sum-exp) in fp32.
TOL_FP32 = 1e-5
TOL_BF16 = 2.0 ** -6
# The train step's soft latent makes every one of the 6,175 keys active, so
# each output sums 6,175 fp32 terms, online (kernel) against two-pass
# (plain): measured 7.4e-6 on an H100 (PERF.md).
TOL_FP32_DENSE = 5e-5
TOL_LSE = 1e-4
# Card vs CPU plain path, flagship model: logits within LOGIT_TOL; latent
# bits may differ only where the logit is within LOGIT_TOL of 0.5; the
# waveform decoded from one shared latent within WAVE_TOL.
LOGIT_TOL = 1e-3
WAVE_TOL = 1e-3
# Seeded random weights give a complex sparser than trained models reach.
# Raising the last encoder bias by LOGIT_SHIFT gives about 90 edges, 60
# triangles and 2 tetrahedra per clip (the serve phase reports the counts),
# the density trained models pass through (README.md: triangles/tetrahedra
# expand to 188/44 early in training, then prune to ~52/2).
LOGIT_SHIFT = 0.5
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, fp32 FLOP/s
# outside the tensor cores, bf16 tensor FLOP/s.
HBM_BPS = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

# The train step (bench.py's flagship step at a batch one card's memory
# and this script's time allow): B anchors, each with a positive and a
# negative, at temperature 1 and accumulation 1.
TRAIN_B = 16
TRAIN_G = 3
TRAIN_STEPS = 10
BF16_STEPS = 3
TEMPERATURE = 1.0
# Attention backward, kernel vs plain: dq, dk, dv within this fraction of
# each gradient's largest element. fp32: sums of up to M products in other
# orders; bf16: both round the same fp32 sums to bf16 once (2^-7 relative).
TOL_BWD = {"float32": 1e-4, "bfloat16": 2.0 ** -7}
# Sampler, kernel vs plain on the kernel's own uniforms (which equal the
# plain Philox stream bit for bit): s in [0, 1]; fp32 log/log1p/exp
# rounding; bf16 output one ulp below 1 (2^-8).
TOL_SAMPLER = {"float32": 2e-6, "bfloat16": 2.0 ** -8}
SAMPLER_DRAWS = 1 << 22
# Train parity, card vs CPU plain path, B=2, G=3, full width. The loss and
# its components: fp32 on both, cuDNN/cuBLAS/cuFFT against oneDNN/pocketfft
# sums. The gradient as a whole: relative L2 over every leaf; the spectral
# loss's log term weighs STFT bins by 1/(|S| + 1e-7), so bins of the
# smooth random-weight reconstruction that sit at fp32 round-off steer the
# gradient with their round-off (see tests/test_torch_training.py). Every
# leaf on its own: through a surrogate (the same forward with the spectral
# distance replaced by a fixed linear functional of the reconstruction),
# within SURROGATE_TOL of the gradient's largest element.
# Measured on an H100 (PERF.md): loss 2.3e-6, gradient 2.2e-3, surrogate
# leaves 2.4e-5; the bounds leave a decade or more.
PARITY_LOSS_RTOL = 1e-4
PARITY_GRAD_REL_L2 = 2e-2
SURROGATE_TOL = 2e-4


class CheckFailed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    """Median of ``reps`` single-call CUDA-event timings after warm-up.

    Before each call the stream is given a ~2 ms spin kernel, so the host
    has enqueued the call before the start event runs: the time is the
    device's, without the wrapper's Python overhead."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(4_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def attention_bound(q, mask, h: int, dtype_name: str) -> tuple[float, str]:
    """Least time for this run's attention: each input read once, each
    output written once, and the operations on the active keys only (the
    kernel neither loads nor scores a masked key)."""
    b, tq, c = q.shape
    active = int((mask > 0).sum().item())
    elt = q.element_size()
    nbytes = (
        q.numel() * elt  # q
        + 2 * active * c * elt  # active rows of K and V
        + mask.numel() * 4  # mask
        + q.numel() * elt  # out
        + b * h * tq * 4  # lse
    )
    flops = 4.0 * tq * c * active  # QK^T and PV, 2 FLOP per FMA, all heads
    t_bytes = nbytes / HBM_BPS
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def measure_attention(torch, attention, q, k, v, mask, h: int, tol: float) -> dict:
    """The kernel against the plain version on the same inputs, and the
    times of the kernel, the plain version and one library call."""
    import torch.nn.functional as F

    b, tq, c = q.shape
    name = str(q.dtype).removeprefix("torch.")
    out, lse = attention.attention_fwd(q, k, v, mask, h)
    torch.cuda.synchronize()
    want, want_lse = attention.attention_fwd_plain(q, k, v, mask, h)
    valid = mask.sum(dim=-1) > 0
    err = (out.float() - want.float()).abs().max().item()
    lse_err = (lse[valid] - want_lse[valid]).abs().max().item()
    check(out.shape == q.shape and out.dtype == q.dtype, f"attention {name}: output shape/dtype")
    check(bool((out[~valid] == 0).all()), f"attention {name}: fully masked element not exactly zero")
    check(bool(torch.isinf(lse[~valid]).all()), f"attention {name}: fully masked lse not +inf")
    check(err <= tol, f"attention {name}: max abs err {err} > {tol}")
    check(lse_err <= TOL_LSE, f"attention {name}: lse err {lse_err} > {TOL_LSE}")

    # One PyTorch library call computing the same function: a yardstick
    # only, never called by the port (it gives NaN where all keys are masked).
    qh, kh, vh = (t.view(t.shape[0], t.shape[1], h, c // h).transpose(1, 2) for t in (q, k, v))
    bool_mask = (mask > 0)[:, None, None, :]

    def library():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bool_mask)

    lib_out = library().transpose(1, 2).reshape(b, tq, c)
    lib_err = (lib_out[valid].float() - want[valid].float()).abs().max().item()
    bound_ms, bound_by = attention_bound(q, mask, h, name)
    return dict(
        dtype=name, max_abs_err=err, tol=tol, lse_max_abs_err=lse_err,
        library_max_abs_err=lib_err,
        ms=time_ms(lambda: attention.attention_fwd(q, k, v, mask, h)),
        plain_ms=time_ms(lambda: attention.attention_fwd_plain(q, k, v, mask, h)),
        library_ms=time_ms(library),
        bound_ms=bound_ms, bound_by=bound_by,
        active_keys=int((mask > 0).sum().item()), keys=int(mask.numel()),
    )


def phase_kernel(torch, attention) -> None:
    """Synthetic inputs at the codec's attention shape: about 40% active
    keys, element 0 fully masked, element 1 with a single active key."""
    dev = torch.device(DEVICE)
    b, tq, m, c, h = (ATTN[k] for k in ("b", "q", "m", "c", "h"))
    rng = np.random.default_rng(SEED)
    base = [rng.standard_normal(s).astype(np.float32) for s in ((b, tq, c), (b, m, c), (b, m, c))]
    mask_np = (rng.uniform(size=(b, m)) < 0.4).astype(np.float32)
    mask_np[0] = 0.0
    mask_np[1] = 0.0
    mask_np[1, 4321] = 1.0
    mask = torch.from_numpy(mask_np).to(dev)
    results = []
    for dtype, tol in ((torch.float32, TOL_FP32), (torch.bfloat16, TOL_BF16)):
        q, k, v = (torch.from_numpy(a).to(dev, dtype) for a in base)
        results.append(measure_attention(torch, attention, q, k, v, mask, h, tol))
        out = attention.fused_masked_attention(q, k, v, mask, h)
        single = (out[1].float() - v[1, 4321].float()).abs().max().item()
        check(single <= tol, f"attention {dtype}: single-key element err {single}")
    emit("kernel", kernel="masked_attention_fwd", inputs="synthetic", shape=ATTN, results=results)


def attention_bwd_bound(q, mask, h: int, dtype_name: str) -> tuple[float, str]:
    """Least time for this run's attention backward: q, O, dO and dq, the
    active rows of K and V, all of dK and dV, the mask and L, each moved
    once; S, dP, dV, dK and dQ on the active keys (10 Q C FLOP per active
    key over all heads)."""
    b, tq, c = q.shape
    m = mask.shape[1]
    active = int((mask > 0).sum().item())
    elt = q.element_size()
    nbytes = (
        4 * q.numel() * elt  # q, O, dO in; dq out
        + 2 * active * c * elt  # active rows of K and V
        + 2 * b * m * c * elt  # dK and dV out (masked rows as zeros)
        + mask.numel() * 4 + b * h * tq * 4  # mask, L
    )
    flops = 10.0 * tq * c * active
    t_bytes = nbytes / HBM_BPS
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def measure_attention_bwd(torch, attention, q, k, v, mask, dout, h: int) -> dict:
    """The backward kernels against the plain backward on the same inputs;
    masked dK/dV rows and a fully masked element's gradients exactly zero;
    times of the kernel, the plain version and SDPA forward + backward."""
    import torch.nn.functional as F

    b, tq, c = q.shape
    name = str(q.dtype).removeprefix("torch.")
    out, lse = attention.attention_fwd(q, k, v, mask, h)
    got = attention.attention_bwd(q, k, v, mask, out, lse, dout, h)
    torch.cuda.synchronize()
    want = attention.attention_bwd_plain(q, k, v, mask, out, lse, dout, h)
    errs, rels = {}, {}
    for key, g, w in zip(("dq", "dk", "dv"), got, want):
        check(g.shape == w.shape and g.dtype == q.dtype, f"attention bwd {name}: {key} shape/dtype")
        errs[key] = (g.float() - w.float()).abs().max().item()
        rels[key] = errs[key] / max(w.float().abs().max().item(), 1e-30)
        check(rels[key] <= TOL_BWD[name], f"attention bwd {name}: {key} rel err {rels[key]}")
    dq, dk, dv = got
    masked = mask == 0
    check(bool((dk[masked] == 0).all() and (dv[masked] == 0).all()),
          f"attention bwd {name}: masked dk/dv rows not exactly zero")
    empty = mask.sum(dim=-1) == 0
    check(bool((dq[empty] == 0).all()), f"attention bwd {name}: fully masked element's dq not zero")

    # SDPA forward + backward through autograd: a yardstick only, never
    # called by the port.
    qh, kh, vh = (t.view(t.shape[0], t.shape[1], h, c // h).transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    doh = dout.view(b, tq, h, c // h).transpose(1, 2)
    bool_mask = (mask > 0)[:, None, None, :]

    def library():
        o = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bool_mask)
        return torch.autograd.grad(o, (qh, kh, vh), doh)

    bound_ms, bound_by = attention_bwd_bound(q, mask, h, name)
    return dict(
        dtype=name, max_abs_err=max(errs.values()), max_abs_err_by_grad=errs, rel_err=rels,
        tol_rel=TOL_BWD[name],
        ms=time_ms(lambda: attention.attention_bwd(q, k, v, mask, out, lse, dout, h)),
        plain_ms=time_ms(lambda: attention.attention_bwd_plain(q, k, v, mask, out, lse, dout, h)),
        library_ms=time_ms(library),
        bound_ms=bound_ms, bound_by=bound_by,
        active_keys=int((mask > 0).sum().item()), keys=int(mask.numel()),
    )


def synthetic_attention(torch, b: int, dtypes, seed: int):
    """[B, 250, 64] queries, [B, 6175, 64] keys/values/dO at the flagship
    shape: about 40% active keys, element 0 fully masked, element 1 a
    single active key (4321)."""
    dev = torch.device(DEVICE)
    tq, m, c = ATTN["q"], ATTN["m"], ATTN["c"]
    rng = np.random.default_rng(seed)
    base = [rng.standard_normal(s).astype(np.float32) for s in ((b, tq, c), (b, m, c), (b, m, c), (b, tq, c))]
    mask_np = (rng.uniform(size=(b, m)) < 0.4).astype(np.float32)
    mask_np[0] = 0.0
    mask_np[1] = 0.0
    mask_np[1, 4321] = 1.0
    mask = torch.from_numpy(mask_np).to(dev)
    for dtype in dtypes:
        yield (*(torch.from_numpy(a).to(dev, dtype) for a in base), mask)


def phase_kernel_bwd(torch, attention) -> None:
    """The attention backward on synthetic inputs at the train step's shape."""
    h = ATTN["h"]
    results = []
    for q, k, v, dout, mask in synthetic_attention(torch, TRAIN_B, (torch.float32, torch.bfloat16), SEED + 1):
        results.append(measure_attention_bwd(torch, attention, q, k, v, mask, dout, h))
    emit("kernel", kernel="masked_attention_bwd", inputs="synthetic",
         shape=dict(ATTN, b=TRAIN_B), results=results)


def sampler_bound(n: int, elt: int) -> tuple[float, str]:
    """Least time for one sampler pass over n logits: read the logits and
    write s once; about 40 operations per element (a quarter of one
    Philox4x32-10 block, the logistic transform, the sigmoid) at the fp32
    rate outside the tensor cores."""
    t_bytes = 2 * n * elt / HBM_BPS
    t_ops = 40.0 * n / PEAK_FLOPS["float32"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernel_sampler(torch, fused, n_simplices: int) -> dict:
    """The binary-Gumbel kernel at the train step's logits [16, 6195]: s
    against the plain relaxation of the kernel's own uniforms, which must
    equal the plain Philox stream bit for bit; reproducibility; the
    uniforms' statistics over 4M draws. No single PyTorch call computes
    this function, so there is no library time."""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(SEED + 2)
    shape = (TRAIN_B, n_simplices)
    results = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        logits = torch.from_numpy(rng.normal(0.5, 2.0, shape).astype(np.float32)).to(dev, dtype)
        s, u = fused.binary_gumbel_sample(logits, TEMPERATURE, seed=SEED, offset=7, return_noise=True)
        torch.cuda.synchronize()
        want_u = fused.philox_uniform(logits.numel(), SEED, 7, dev).reshape(shape)
        check(torch.equal(u, want_u), f"sampler {name}: kernel uniforms differ from the Philox stream")
        want = fused.binary_gumbel_plain(logits, u, TEMPERATURE)
        err = (s.float() - want.float()).abs().max().item()
        check(s.dtype == dtype and s.shape == logits.shape, f"sampler {name}: shape/dtype")
        check(err <= TOL_SAMPLER[name], f"sampler {name}: max abs err {err} > {TOL_SAMPLER[name]}")
        again = fused.binary_gumbel_sample(logits, TEMPERATURE, seed=SEED, offset=7)
        other = fused.binary_gumbel_sample(logits, TEMPERATURE, seed=SEED + 1, offset=7)
        check(torch.equal(again, s), f"sampler {name}: the same (seed, offset) does not reproduce")
        check(not torch.equal(other, s), f"sampler {name}: another seed gives the same sample")
        noise_s = fused.binary_gumbel_sample(logits, TEMPERATURE, noise=u)
        check((noise_s.float() - want.float()).abs().max().item() <= TOL_SAMPLER[name],
              f"sampler {name}: the injected-noise entry point disagrees")

        def plain():
            uu = fused.philox_uniform(logits.numel(), SEED, 7, dev).reshape(shape)
            return fused.binary_gumbel_plain(logits, uu, TEMPERATURE)

        bound_ms, bound_by = sampler_bound(logits.numel(), logits.element_size())
        results.append(dict(
            dtype=name, max_abs_err=err, tol=TOL_SAMPLER[name],
            ms=time_ms(lambda: fused.binary_gumbel_sample(logits, TEMPERATURE, seed=SEED, offset=7)),
            plain_ms=time_ms(plain), library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
        ))
    _, u = fused.binary_gumbel_sample(torch.zeros(SAMPLER_DRAWS, device=dev), 1.0, seed=SEED + 3,
                                      return_noise=True)
    n = u.numel()
    mean_tol = 5 * (1 / 12) ** 0.5 / n ** 0.5  # 5 standard errors
    frac_tol = 5 * 0.5 / n ** 0.5
    mean = u.mean().item()
    below = (u < 0.5).float().mean().item()
    check(abs(mean - 0.5) <= mean_tol, f"sampler uniforms: mean {mean}")
    check(abs(below - 0.5) <= frac_tol, f"sampler uniforms: fraction below 0.5 {below}")
    check(u.min().item() >= np.float32(1e-6) and u.max().item() <= np.float32(1 - 1e-6), "uniforms out of range")
    emit("kernel", kernel="binary_gumbel", inputs="synthetic", shape=list(shape), results=results,
         uniforms=dict(draws=n, mean=mean, mean_tol=mean_tol, frac_below_half=below, frac_tol=frac_tol))
    return results[0]


def make_clips(batch: int, seed: int) -> np.ndarray:
    """[B, 1, 64000] float32: a few sines plus noise, from a seed."""
    rng = np.random.default_rng(seed)
    t = np.arange(NUM_SAMPLES) / 16000.0
    freqs = rng.uniform(60.0, 6000.0, size=(batch, 4, 1))
    amps = rng.uniform(0.05, 0.4, size=(batch, 4, 1))
    x = (amps * np.sin(2 * np.pi * freqs * t)).sum(axis=1)
    x += 0.02 * rng.standard_normal((batch, NUM_SAMPLES))
    return x[:, None, :].astype(np.float32)


def phase_serve(torch, port, counters) -> tuple:
    model = port.AudioAutoencoder.create(**FLAGSHIP, num_samples=NUM_SAMPLES, seed=SEED, device=DEVICE)
    with torch.no_grad():
        model.encoder.mlp2.bias += LOGIT_SHIFT
    codec = port.Codec(model, device=DEVICE)
    n = FLAGSHIP["num_vertices"]
    for c in counters.values():
        c.launches = 0  # just before the serve path
    decoder_calls = 0
    timed = []
    for i in range(REQUESTS + 1):  # request 0 warms up
        x = make_clips(CLIPS, SEED + i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        latent = codec.encode(x)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        wire = port.pack_latent(latent)
        back = port.unpack_latent(wire, n)
        t2 = time.perf_counter()
        y = codec.decode(back, NUM_SAMPLES)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        rec = codec.reconstruct(x)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        decoder_calls += 2
        check(wire.shape == (CLIPS, math.ceil(sum(model.tables.sizes) / 8)), "wire size")
        for a, b in zip(latent.ranks, back.ranks):
            check(torch.equal(a.cpu(), b), "latent does not round-trip bit-exactly")
        for w in (y, rec):
            check(tuple(w.shape) == (CLIPS, 1, NUM_SAMPLES), f"waveform shape {tuple(w.shape)}")
            check(bool(torch.isfinite(w).all()), "non-finite waveform")
        if i > 0:
            timed.append(dict(
                encode_ms=(t1 - t0) * 1e3, pack_unpack_ms=(t2 - t1) * 1e3,
                decode_ms=(t3 - t2) * 1e3, reconstruct_ms=(t4 - t3) * 1e3,
                active=[float(r.sum(dim=-1).mean()) for r in latent.ranks],
            ))
    counts = {name: c.launches for name, c in counters.items()}  # just after the serve path
    launches = counts["masked_attention_fwd"]
    check(launches == decoder_calls, f"attention launches {launches} != decoder calls {decoder_calls}")
    check(counts["masked_attention_bwd"] == 0 and counts["binary_gumbel"] == 0,
          f"the eval path launched training kernels: {counts}")
    enc = statistics.median(t["encode_ms"] for t in timed)
    dec = statistics.median(t["decode_ms"] for t in timed)
    emit(
        "serve", config=FLAGSHIP, clips=CLIPS, samples=NUM_SAMPLES, requests=timed,
        encode_ms=enc, decode_ms=dec, clips_per_s=CLIPS / ((enc + dec) / 1e3),
        wire_bytes_per_clip=int(wire.shape[1]), attention_launches=launches,
        launches=counts, decoder_calls=decoder_calls, num_params=model.num_params(),
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
    )
    return model, codec


def phase_main_attention(torch, attention, model, codec) -> dict:
    """The kernel on the attention inputs of one more decode of the main
    path (captured after its launch counts were read)."""
    ca = model.decoder.cross_attention
    captured = {}

    def grab(module, args):
        captured["args"] = tuple(a.detach().clone() for a in args)

    handle = ca.register_forward_pre_hook(grab)
    try:
        codec.decode(codec.encode(make_clips(CLIPS, SEED)), NUM_SAMPLES)
    finally:
        handle.remove()
    query, keys, values, mask = captured["args"]
    with torch.inference_mode():
        q, k, v = ca.q_proj(query), ca.k_proj(keys), ca.v_proj(values)
        result = measure_attention(torch, attention, q, k, v, mask, ca.num_heads, TOL_FP32)
    emit("kernel", kernel="masked_attention_fwd", inputs="main path decode",
         shape=dict(b=q.shape[0], q=q.shape[1], m=k.shape[1], c=q.shape[2], h=ca.num_heads),
         results=[result])
    return result


def phase_trace(torch, codec) -> None:
    """Where one decode of 8 clips spends device time (torch.profiler):
    device busy share, and the top ops by inclusive and kernels by self
    device time. Recorded, not checked."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    latent = codec.encode(make_clips(CLIPS, SEED))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        codec.decode(latent, NUM_SAMPLES)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = sorted(
        (e for e in events if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
        key=lambda e: -e.self_device_time_total,
    )
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    ops = sorted(
        (e for e in events if e.key.startswith("aten::") and e.device_time_total > 0),
        key=lambda e: -e.device_time_total,
    )
    emit(
        "trace", what="one Codec.decode of 8 clips under torch.profiler",
        wall_ms_profiled=wall_ms, device_ms=device_ms, kernel_launches=sum(e.count for e in kernels),
        device_busy_share_profiled=device_ms / wall_ms,
        top_ops=[(e.key, e.device_time_total / 1e3, e.count) for e in ops[:12]],
        top_kernels=[(e.key[:90], e.self_device_time_total / 1e3, e.count) for e in kernels[:12]],
    )


def phase_parity(torch, port, model, codec) -> None:
    """The card's weights on a CPU model; plain path vs the card."""
    x = make_clips(2, SEED + 100)
    cpu_model = port.AudioAutoencoder.create(**FLAGSHIP, num_samples=NUM_SAMPLES, seed=SEED + 1, device="cpu")
    cpu_codec = port.Codec(cpu_model, {k: t.cpu() for k, t in model.state_dict().items()}, device="cpu")
    with torch.inference_mode():
        gpu_enc = model.encode(torch.from_numpy(x).to(DEVICE))
        cpu_enc = cpu_model.encode(torch.from_numpy(x))
    logits = cpu_enc.logits.numpy()
    logit_err = float(np.abs(gpu_enc.logits.cpu().numpy() - logits).max())
    check(logit_err <= LOGIT_TOL, f"logits card vs cpu: {logit_err} > {LOGIT_TOL}")
    # Bits before the rectifier: a flip is allowed only where the CPU's
    # logit lies within LOGIT_TOL of the threshold.
    bias = np.zeros_like(logits)
    bias[:, : FLAGSHIP["num_vertices"]] = float(model.encoder.vertex_bias.detach().relu())
    raw_cpu = logits + bias > 0.5
    raw_gpu = gpu_enc.logits.cpu().numpy() + bias > 0.5
    near = np.abs(logits + bias - 0.5) <= LOGIT_TOL
    flipped = raw_cpu != raw_gpu
    check(not (flipped & ~near).any(), "latent bits flip away from the threshold")
    if not flipped.any():
        for a, b in zip(gpu_enc.probs.ranks, cpu_enc.probs.ranks):
            check(torch.equal(a.cpu(), b), "rectified latents differ with equal raw bits")
    latent = port.SimplicialLatent(*cpu_enc.probs.ranks)
    wave_gpu = codec.decode(latent, NUM_SAMPLES).cpu().numpy()
    wave_cpu = cpu_codec.decode(latent, NUM_SAMPLES).numpy()
    wave_err = float(np.abs(wave_gpu - wave_cpu).max())
    check(np.isfinite(wave_cpu).all(), "non-finite CPU waveform")
    check(wave_err <= WAVE_TOL, f"decode card vs cpu: {wave_err} > {WAVE_TOL}")
    rec_err = None
    if not flipped.any():
        rec_gpu = codec.reconstruct(x).cpu().numpy()
        rec_cpu = cpu_codec.reconstruct(x).numpy()
        rec_err = float(np.abs(rec_gpu - rec_cpu).max())
        check(rec_err <= WAVE_TOL, f"reconstruct card vs cpu: {rec_err} > {WAVE_TOL}")
    emit(
        "parity", clips=2, logit_max_abs_err=logit_err, logit_tol=LOGIT_TOL,
        bits_flipped=int(flipped.sum()), bits_near_threshold=int(near.sum()),
        decode_max_abs_err=wave_err, reconstruct_max_abs_err=rec_err, wave_tol=WAVE_TOL,
        wave_max_abs=float(np.abs(wave_cpu).max()),
    )


def train_batch(seed: int, b: int) -> np.ndarray:
    """[B, G, 1, 64000]: anchor, positive and negative clips, made as the
    serve phase makes its clips."""
    return make_clips(b * TRAIN_G, seed).reshape(b, TRAIN_G, 1, NUM_SAMPLES)


def phase_train(torch, port, counters) -> tuple:
    """The flagship train step at full width, fp32: a warm-up step and
    TRAIN_STEPS timed ones, then BF16_STEPS bf16 steps. Every loss
    component of every step must be finite."""
    model = port.AudioAutoencoder.create(**FLAGSHIP, num_samples=NUM_SAMPLES, seed=SEED, device=DEVICE)
    opt = port.make_optimizer(accumulate_grad_batches=1)
    state = port.create_train_state(model, opt)
    step = port.make_train_step(model, opt)
    batches = [torch.from_numpy(train_batch(SEED + 300 + i, TRAIN_B)).to(DEVICE)
               for i in range(TRAIN_STEPS + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0  # just before the main path
    times, metrics = [], []
    for batch in batches:  # step 0 warms up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch, TEMPERATURE, SEED)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        metrics.append(m)
    launches = {name: c.launches for name, c in counters.items()}  # just after
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    steps = len(batches)
    per_step = {name: n / steps for name, n in launches.items()}
    check(launches["binary_gumbel"] == steps, f"sampler launches {launches} for {steps} steps")
    check(launches["masked_attention_fwd"] == steps, f"attention fwd launches {launches} for {steps} steps")
    check(launches["masked_attention_bwd"] >= steps, f"attention bwd launches {launches} for {steps} steps")
    components = [{k: float(v) for k, v in m.items()} for m in metrics]
    for i, comp in enumerate(components):
        check(all(math.isfinite(v) for v in comp.values()), f"train step {i}: non-finite loss {comp}")
    step_ms = statistics.median(times[1:])

    bf16_opt = port.make_optimizer(accumulate_grad_batches=1)
    bf16_state = port.create_train_state(model, bf16_opt)
    bf16_step = port.make_train_step(model, bf16_opt, compute_dtype=torch.bfloat16)
    bf16_times, bf16_components = [], []
    for batch in batches[:BF16_STEPS]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bf16_state, m = bf16_step(bf16_state, batch, TEMPERATURE, SEED)
        torch.cuda.synchronize()
        bf16_times.append((time.perf_counter() - t0) * 1e3)
        bf16_components.append({k: float(v) for k, v in m.items()})
    for i, comp in enumerate(bf16_components):
        check(all(math.isfinite(v) for v in comp.values()), f"bf16 train step {i}: non-finite loss {comp}")
    check(all(p.dtype == torch.float32 and bool(torch.isfinite(p).all()) for p in model.parameters()),
          "master parameters not finite fp32 after the bf16 steps")
    emit(
        "train", config=FLAGSHIP, anchors=TRAIN_B, group=TRAIN_G, samples=NUM_SAMPLES,
        dtype="float32", temperature=TEMPERATURE, steps_timed=TRAIN_STEPS, step_ms=times,
        step_ms_median=step_ms, anchors_per_s=TRAIN_B / (step_ms / 1e3),
        clips_per_s=TRAIN_B * TRAIN_G / (step_ms / 1e3), components=components,
        launches=launches, launches_per_step=per_step, peak_mem_gib=peak_gib,
        num_params=model.num_params(),
        bf16=dict(step_ms=bf16_times, components=bf16_components),
    )
    return model, state, step, batches[0], launches


def phase_train_kernels(torch, attention, model, state, step, batch) -> tuple:
    """The attention forward and backward kernels on the inputs of one more
    train step's cross-attention: q, k, v, the mask, and the gradient dO
    that reached the attention output (captured after the launch counts
    were read)."""
    ca = model.decoder.cross_attention
    cap = {}
    hooks = [
        ca.register_forward_pre_hook(lambda m, args: cap.__setitem__("mask", args[3].detach().clone())),
        ca.q_proj.register_forward_hook(lambda m, a, o: cap.__setitem__("q", o.detach().clone())),
        ca.k_proj.register_forward_hook(lambda m, a, o: cap.__setitem__("k", o.detach().clone())),
        ca.v_proj.register_forward_hook(lambda m, a, o: cap.__setitem__("v", o.detach().clone())),
        ca.out_proj.register_full_backward_hook(
            lambda m, gin, gout: cap.__setitem__("dout", gin[0].detach().clone())),
    ]
    try:
        step(state, batch, TEMPERATURE, SEED)
        torch.cuda.synchronize()
    finally:
        for hk in hooks:
            hk.remove()
    q, k, v, mask, dout = (cap[n].contiguous() for n in ("q", "k", "v", "mask", "dout"))
    shape = dict(b=q.shape[0], q=q.shape[1], m=k.shape[1], c=q.shape[2], h=ca.num_heads)
    with torch.inference_mode():
        fwd = measure_attention(torch, attention, q, k, v, mask, ca.num_heads, TOL_FP32_DENSE)
    bwd = measure_attention_bwd(torch, attention, q, k, v, mask, dout, ca.num_heads)
    emit("kernel", kernel="masked_attention_fwd", inputs="main path train step", shape=shape, results=[fwd])
    emit("kernel", kernel="masked_attention_bwd", inputs="main path train step", shape=shape, results=[bwd])
    return fwd, bwd


def phase_train_trace(torch, state, step, batch) -> None:
    """Where one train step spends device time (torch.profiler): device
    busy share, top ops and kernels. Recorded, not checked."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch, TEMPERATURE, SEED)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = sorted(
        (e for e in events if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
        key=lambda e: -e.self_device_time_total,
    )
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    ops = sorted(
        (e for e in events if e.key.startswith("aten::") and e.device_time_total > 0),
        key=lambda e: -e.device_time_total,
    )
    emit(
        "trace", what="one flagship train step (fp32, B=16, G=3) under torch.profiler",
        wall_ms_profiled=wall_ms, device_ms=device_ms, kernel_launches=sum(e.count for e in kernels),
        device_busy_share_profiled=device_ms / wall_ms,
        top_ops=[(e.key, e.device_time_total / 1e3, e.count) for e in ops[:15]],
        top_kernels=[(e.key[:90], e.self_device_time_total / 1e3, e.count) for e in kernels[:15]],
    )


def surrogate(torch, model, batch, noise, w):
    """The train objective's forward with the spectral distance replaced by
    <recon, w>: well conditioned in every gradient leaf."""
    from topo_audio_autoencoder_torch.models.encoder import (
        info_nce_loss,
        rank_diversity_entropy,
        vertex_count_penalty,
    )

    b, g, _, t = batch.shape
    flat = batch.reshape(b * g, 1, t)
    logits = model.encoder.compute_logits(model.pqmf(flat).transpose(-1, -2), True)
    contrastive = info_nce_loss(logits.reshape(b, g, -1))
    enc = model.encoder.generate_complex(logits.reshape(b, g, -1)[:, 0], TEMPERATURE, True, noise=noise)
    recon = model.decode(enc, t // model.num_bands, True)
    reg = rank_diversity_entropy(enc.rectified).mean() + vertex_count_penalty(
        enc.rectified.vertices, model.min_active_vertices, model.max_active_vertices).mean()
    return (recon * w).sum() + contrastive + reg


def phase_train_parity(torch, port, training) -> None:
    """One train step's loss and gradients on the card against the CPU plain
    path: the same weights (dropout off), batch and injected uniforms."""
    gpu = port.AudioAutoencoder.create(**FLAGSHIP, num_samples=NUM_SAMPLES, seed=SEED + 2,
                                       device=DEVICE, dropout=0.0)
    cpu = port.AudioAutoencoder.create(**FLAGSHIP, num_samples=NUM_SAMPLES, seed=SEED + 3,
                                       device="cpu", dropout=0.0)
    cpu.load_state_dict({k: t.cpu() for k, t in gpu.state_dict().items()})
    batch = torch.from_numpy(train_batch(SEED + 400, b=2))
    rng = np.random.default_rng(SEED + 5)
    noise = torch.from_numpy(rng.uniform(1e-6, 1 - 1e-6, (2, gpu.tables.total_simplices)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((2, 1, NUM_SAMPLES)).astype(np.float32))

    def run(model, device):
        total, comps, grads = training.make_loss_and_grads(model)(
            batch.to(device), TEMPERATURE, SEED, 0, noise.to(device))
        names, params = zip(*model.named_parameters())
        val = surrogate(torch, model, batch.to(device), noise.to(device), w.to(device))
        sgrads = dict(zip(names, torch.autograd.grad(val, params)))
        return (float(total), {k: float(v) for k, v in comps.items()},
                {n: g.cpu().double() for n, g in grads.items()}, val.item(),
                {n: g.detach().cpu().double() for n, g in sgrads.items()})

    g_total, g_comps, g_grads, g_val, g_sgrads = run(gpu, DEVICE)
    c_total, c_comps, c_grads, c_val, c_sgrads = run(cpu, "cpu")
    loss_err = abs(g_total - c_total) / abs(c_total)
    check(loss_err <= PARITY_LOSS_RTOL, f"train loss card vs cpu: rel {loss_err}")
    comp_err = {k: abs(g_comps[k] - c_comps[k]) / max(abs(c_comps[k]), 1e-6) for k in c_comps}
    check(max(comp_err.values()) <= PARITY_LOSS_RTOL, f"loss components card vs cpu: {comp_err}")

    def l2(ts):
        return math.sqrt(sum(float((t ** 2).sum()) for t in ts))

    check(g_grads.keys() == c_grads.keys(), "gradient leaves differ")
    check(all(bool(torch.isfinite(g).all()) for g in g_grads.values()), "non-finite card gradient")
    grad_err = l2(g_grads[n] - c_grads[n] for n in c_grads) / l2(c_grads.values())
    check(grad_err <= PARITY_GRAD_REL_L2, f"train gradient card vs cpu: rel L2 {grad_err}")
    scale = max(float(g.abs().max()) for g in c_sgrads.values())
    leaf_err = {n: float((g_sgrads[n] - c_sgrads[n]).abs().max()) / scale for n in c_sgrads}
    worst = max(leaf_err, key=leaf_err.get)
    check(leaf_err[worst] <= SURROGATE_TOL, f"surrogate gradient leaf {worst}: {leaf_err[worst]}")
    sur_err = abs(g_val - c_val) / abs(c_val)
    emit(
        "train_parity", anchors=2, group=TRAIN_G, leaves=len(c_grads),
        loss_rel_err=loss_err, component_rel_err=comp_err, loss_rtol=PARITY_LOSS_RTOL,
        grad_rel_l2=grad_err, grad_rel_l2_tol=PARITY_GRAD_REL_L2,
        surrogate_value_rel_err=sur_err, surrogate_leaf_max_err=leaf_err[worst], surrogate_worst_leaf=worst,
        surrogate_tol=SURROGATE_TOL, grad_scale=scale,
        worst_leaves=sorted(leaf_err.items(), key=lambda kv: -kv[1])[:5],
    )


def kernel_entry(name, source, replaces, launches, result) -> dict:
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": result["max_abs_err"], "ms": result["ms"],
        "plain_ms": result["plain_ms"], "bound_ms": result["bound_ms"],
        "bound_by": result["bound_by"], "library_ms": result["library_ms"],
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on the card", file=sys.stderr)
        return 2
    try:
        import topo_audio_autoencoder_torch as port
        from topo_audio_autoencoder_torch import cuda_build, training
        from topo_audio_autoencoder_torch.ops import attention
        from topo_audio_autoencoder_torch.ops import fused_samplers as fused
    except ImportError as e:
        print(f"chip_smoke: the port is not importable ({e}); run from the repo root", file=sys.stderr)
        return 2

    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    built = cuda_build.build()
    build_s = time.perf_counter() - t0
    emit(
        "env", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0), device_count=torch.cuda.device_count(),
        build_s=build_s, built=built,
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
    )
    counters = {
        "masked_attention_fwd": attention.attention_fwd,
        "masked_attention_bwd": attention.attention_bwd,
        "binary_gumbel": fused.binary_gumbel_sample,
    }
    try:
        phase_kernel(torch, attention)
        phase_kernel_bwd(torch, attention)
        n = FLAGSHIP["num_vertices"]
        sampler = phase_kernel_sampler(torch, fused, sum(math.comb(n, k) for k in range(1, 5)))
        model, codec = phase_serve(torch, port, counters)
        phase_main_attention(torch, attention, model, codec)
        phase_trace(torch, codec)
        phase_parity(torch, port, model, codec)
        del model, codec
        tmodel, tstate, tstep, tbatch, launches = phase_train(torch, port, counters)
        fwd, bwd = phase_train_kernels(torch, attention, tmodel, tstate, tstep, tbatch)
        phase_train_trace(torch, tstate, tstep, tbatch)
        del tmodel, tstate, tstep
        torch.cuda.empty_cache()
        phase_train_parity(torch, port, training)
    except CheckFailed as e:
        print(f"chip_smoke: check failed: {e}", file=sys.stderr)
        return 1
    csrc = "topo_audio_autoencoder_torch/csrc/"
    print(json.dumps({"kernels": [
        kernel_entry("masked_attention_fwd", csrc + "masked_attention_fwd.cu",
                     "topo_audio_autoencoder_tpu/ops/attention.py:54",
                     launches["masked_attention_fwd"], fwd),
        kernel_entry("masked_attention_bwd", csrc + "masked_attention_bwd.cu",
                     "topo_audio_autoencoder_tpu/ops/attention.py:122",
                     launches["masked_attention_bwd"], bwd),
        kernel_entry("binary_gumbel", csrc + "binary_gumbel.cu",
                     "topo_audio_autoencoder_tpu/ops/pallas_kernels.py:216",
                     launches["binary_gumbel"], sampler),
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
