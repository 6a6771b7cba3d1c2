#!/usr/bin/env python3
"""Drive the PyTorch port's codec on one CUDA card and hold its kernels
against their plain versions.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card (an H100:
the kernels are built for sm_90a). Phases, one JSON line each:

1. env     the card (nvidia-smi name and power limit), versions, the
           kernels' build (all sources compiled at once, one nvcc each).
2. kernel  each CUDA kernel against its plain torch version on the card,
           at the codec's attention shape, in fp32 and bf16, with times
           (CUDA events, median of 30 after warm-up) for the kernel, the
           plain version and one PyTorch library call, and the bound.
3. serve   the flagship-width codec (n=20, 16 bands, C=64, 6 SCCN
           layers, seeded random weights): a warm-up request and three
           timed ones of 8 clips x 64,000 samples, each encode -> pack ->
           unpack -> decode plus one reconstruct. Launch counters are
           zeroed just before and read just after.
   kernel  again, on the attention inputs of one more main-path decode.
4. trace   one decode under torch.profiler: device busy share, top ops.
5. parity  the card's weights copied to a CPU model; the plain path's
           logits, latent and waveform against the card's.
6. kernels one line per kernel: route, source, launches, error, times
           (from the main-path inputs).

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


def make_clips(batch: int, seed: int) -> np.ndarray:
    """[B, 1, 64000] float32: a few sines plus noise, from a seed."""
    rng = np.random.default_rng(seed)
    t = np.arange(NUM_SAMPLES) / 16000.0
    freqs = rng.uniform(60.0, 6000.0, size=(batch, 4, 1))
    amps = rng.uniform(0.05, 0.4, size=(batch, 4, 1))
    x = (amps * np.sin(2 * np.pi * freqs * t)).sum(axis=1)
    x += 0.02 * rng.standard_normal((batch, NUM_SAMPLES))
    return x[:, None, :].astype(np.float32)


def phase_serve(torch, port, attention) -> tuple:
    model = port.AudioAutoencoder.create(**FLAGSHIP, num_samples=NUM_SAMPLES, seed=SEED, device=DEVICE)
    with torch.no_grad():
        model.encoder.mlp2.bias += LOGIT_SHIFT
    codec = port.Codec(model, device=DEVICE)
    n = FLAGSHIP["num_vertices"]
    attention.attention_fwd.launches = 0  # just before the main path
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
    launches = attention.attention_fwd.launches  # just after the main path
    check(launches == decoder_calls, f"attention launches {launches} != decoder calls {decoder_calls}")
    enc = statistics.median(t["encode_ms"] for t in timed)
    dec = statistics.median(t["decode_ms"] for t in timed)
    emit(
        "serve", config=FLAGSHIP, clips=CLIPS, samples=NUM_SAMPLES, requests=timed,
        encode_ms=enc, decode_ms=dec, clips_per_s=CLIPS / ((enc + dec) / 1e3),
        wire_bytes_per_clip=int(wire.shape[1]), attention_launches=launches,
        decoder_calls=decoder_calls, num_params=model.num_params(),
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
    )
    return model, codec, {"masked_attention_fwd": launches}


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on the card", file=sys.stderr)
        return 2
    try:
        import topo_audio_autoencoder_torch as port
        from topo_audio_autoencoder_torch import cuda_build
        from topo_audio_autoencoder_torch.ops import attention
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
    try:
        phase_kernel(torch, attention)
        model, codec, launches = phase_serve(torch, port, attention)
        k = phase_main_attention(torch, attention, model, codec)
        phase_trace(torch, codec)
        phase_parity(torch, port, model, codec)
    except CheckFailed as e:
        print(f"chip_smoke: check failed: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [{
        "name": "masked_attention_fwd",
        "route": "cuda",
        "source": "topo_audio_autoencoder_torch/csrc/masked_attention_fwd.cu",
        "replaces": "topo_audio_autoencoder_tpu/ops/attention.py:54",
        "launches": launches["masked_attention_fwd"],
        "max_abs_err": k["max_abs_err"],
        "ms": k["ms"],
        "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"],
        "library_ms": k["library_ms"],
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
