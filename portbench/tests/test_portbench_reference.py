"""The plain reference against the port at a tiny size on the CPU, where
the port runs its plain paths: the same weights, inputs and seeds give the
same answers."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import common, inputs
from portbench.reference import codec as ref_codec
from portbench.reference import samplers as ref_samplers
from portbench.reference import train as ref_train
from portbench.tests import tiny

SEED = 2**31 + 5


def models(workload: str):
    import topo_audio_autoencoder_torch as port

    _, cfg, traffic, _ = tiny.cell(workload)
    prog = common.program_model(torch, port, cfg, SEED, "cpu")
    ref = common.reference_model(torch, cfg, SEED, "cpu")
    return cfg, traffic, prog, ref


def rel_l2(a: dict, b: dict) -> float:
    num = sum(float(torch.sum((a[n] - b[n]) ** 2)) for n in b)
    return (num / sum(float(torch.sum(b[n] ** 2)) for n in b)) ** 0.5


def test_same_parameters():
    _, _, prog, ref = models(tiny.CODEC)
    ps, rs = prog.state_dict(), ref.state_dict()
    assert set(ps) == set(rs)
    assert all(torch.equal(ps[n], rs[n]) for n in rs)


@pytest.mark.parametrize("first", [0, 3, 4097])
def test_philox_stream(first):
    from topo_audio_autoencoder_torch.ops.fused_samplers import philox_uniform

    a = philox_uniform(1001, 2**40 + 3, 0, "cpu", first)
    b = ref_samplers.philox_uniform(1001, 2**40 + 3, 0, "cpu", first)
    assert torch.equal(a, b)


@pytest.mark.parametrize("workload", [tiny.CODEC, tiny.TRAIN])
def test_codec_bits_and_waveform(workload):
    import topo_audio_autoencoder_torch as port

    cfg, _, prog, ref = models(workload)
    clips = inputs.make_clips(6, cfg["model"]["num_samples"], SEED, "requests", "cpu")[:, None]
    codec = port.Codec(prog, device="cpu")
    packed = port.pack_latent(codec.encode(clips))
    sizes = ref.tables.sizes
    bits = np.unpackbits(packed, axis=-1, count=sum(sizes)).astype(bool)
    assert np.array_equal(bits, ref_codec.encode_bits(ref, clips, block=4))
    assert bits.sum() > 0
    wave = codec.decode(port.unpack_latent(packed, cfg["model"]["num_vertices"]), clips.shape[-1])[:, 0].numpy()
    ref_wave = ref_codec.decode_bits(ref, bits, clips.shape[-1], "cpu", block=4)
    assert np.abs(wave - ref_wave).max() <= 1e-5 * np.abs(ref_wave).max()


def test_train_step_loss_and_gradients():
    from topo_audio_autoencoder_torch.training.train_step import make_loss_and_grads

    cfg, traffic, prog, ref = models(tiny.TRAIN)
    samples = cfg["model"]["num_samples"]
    corpus = inputs.make_clips(traffic["corpus_clips"], samples, SEED, "corpus", "cpu")
    idx = inputs.index_groups(traffic["corpus_clips"], 2, traffic["batch"], traffic["group"], SEED)
    batch = corpus[torch.as_tensor(idx[1])][:, :, None, :]
    total, _, grads = make_loss_and_grads(prog)(batch, 5.0, SEED, 1)
    parts, ref_grads = ref_train.loss_and_grads(ref, batch, 5.0, SEED, 1)
    loss = parts["total_loss"]
    assert abs(float(total) - loss) <= 1e-6 * abs(loss)
    assert rel_l2(grads, ref_grads) <= 1e-4
    # Row blocks draw the batch's randomness and average to its step. The
    # gradient sums in another order, and the spectral loss's log term makes
    # the whole gradient move by ~2e-2 under fp32 reorderings (PERF.md).
    blocked, blocked_grads = ref_train.loss_and_grads(ref, batch, 5.0, SEED, 1, blocks=2)
    assert abs(blocked["total_loss"] - loss) <= 1e-5 * abs(loss)
    assert rel_l2(blocked_grads, ref_grads) <= 5e-2


def test_reference_imports_no_port():
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, '.');"
            "import portbench.reference.train, portbench.reference.codec;"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'topo_audio_autoencoder_torch', 'topo_audio_autoencoder_tpu', 'jax', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         cwd=str(tiny.harness.ROOT))
    assert out.stdout.strip() == "[]"
