"""The port's codec CLI against the JAX package's: the JAX CLI tests'
cases on the port's CLI (``--device cpu``), and ``.tac`` files across the
two packages in both directions.

Parameters go across with ``convert.state_dict_from_flax``: the JAX CLI
reads a flax tree saved by the JAX ``save_params``, the port's CLI the
converted ``state_dict`` saved by the port's. Bits are compared only where
the JAX logit lies beyond ``MARGIN`` of the threshold (as in
test_torch_codec.py), waveforms within ``WAVE_ATOL`` plus one int16 step.
"""

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import TINY, flax_params, margin_mask, waveforms

from topo_audio_autoencoder_torch import codec_cli as pt_cli
from topo_audio_autoencoder_torch.convert import state_dict_from_flax
from topo_audio_autoencoder_torch.data.preprocess import load_wav, save_wav
from topo_audio_autoencoder_torch.inference import Codec, save_params, unpack_latent
from topo_audio_autoencoder_torch.models import AudioAutoencoder
from topo_audio_autoencoder_torch.training.checkpoint import CheckpointManager
from topo_audio_autoencoder_tpu import codec_cli as jax_cli
from topo_audio_autoencoder_tpu import inference as jax_inf
from topo_audio_autoencoder_tpu.models import AudioAutoencoder as JaxAutoencoder

torch.set_num_threads(1)

T = 4096  # tests/test_codec_cli.py's clip length
GEOM = ["--vertices", "5", "--bands", "4", "--hidden", "8", "--layers", "2"]
CPU = ["--device", "cpu"]
WAVE_ATOL = 1e-4  # fp32 in both packages (test_torch_codec.py)
INT16_STEP = 2.0 / 32768.0
MARGIN = 2e-3  # compare latent bits only this far from the threshold


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("codec_cli")
    jm = JaxAutoencoder.create(**TINY)
    params = flax_params(jm, num_samples=T)
    model = AudioAutoencoder.create(**TINY, num_samples=T, device="cpu")
    sd = state_dict_from_flax(params, model.state_dict())
    model.load_state_dict(sd)
    save_params(root / "params", sd)
    jax_inf.save_params(root / "jax_params", params)
    wavs = []
    for i, x in enumerate(waveforms(3, 2, T)):
        p = root / f"in_{i}.wav"
        save_wav(p, x, 16000)
        wavs.append(str(p))
    return dict(jm=jm, params=params, model=model, sd=sd, root=root, wavs=wavs)


def test_encode_decode_roundtrip(setup, capsys):
    model, root, wavs = setup["model"], setup["root"], setup["wavs"]
    tac = root / "clips.tac"
    pt_cli.main(["encode", str(tac), *wavs, "--params", str(root / "params"),
                 *GEOM, *CPU, "--batch", "2", "--clip-samples", str(T)])
    enc_report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    packed, header = pt_cli.read_tac(tac)
    total = sum(model.tables.sizes)  # 5 + 10 + 10 + 5 = 30 bits
    assert packed.shape == (2, (total + 7) // 8)
    assert enc_report["bytes_per_clip"] == (total + 7) // 8
    assert header["vertices"] == 5 and header["num_samples"] == T

    out_dir = root / "recon"
    pt_cli.main(["decode", str(tac), str(out_dir), "--params", str(root / "params"), *CPU, "--batch", "2"])
    files = sorted(out_dir.glob("in_*.wav"))
    assert len(files) == 2

    # The CLI output equals a direct Codec decode of the same bitstream
    # (within the wav container's int16 quantization).
    direct = Codec(model, device="cpu").decode(unpack_latent(packed, 5), T).numpy()
    for j, f in enumerate(files):
        np.testing.assert_allclose(load_wav(f), np.clip(direct[j, 0], -1.0, 1.0), atol=INT16_STEP)


def _trainer_checkpoint(setup, directory):
    """A Trainer-style checkpoint: the train state's parameters under
    "params", the model's geometry stamped in the sidecar."""
    CheckpointManager(directory).save(
        "best", {"params": setup["sd"], "step": 0},
        extra={"model": setup["model"].geometry(), "encoder_lr": 1e-3},
    )


def test_sidecar_geometry(setup, capsys, tmp_path):
    """The CLI reads the geometry from the sidecar (no --vertices/...
    flags needed) and rejects an explicit flag that disagrees, with the JAX
    CLI's message."""
    _trainer_checkpoint(setup, tmp_path / "ckpt")
    tac = tmp_path / "clips.tac"
    pt_cli.main(["encode", str(tac), setup["wavs"][0], "--checkpoint", str(tmp_path / "ckpt"), *CPU,
                 "--clip-samples", str(T)])
    capsys.readouterr()
    _, header = pt_cli.read_tac(tac)
    assert header["vertices"] == 5
    assert header["hidden"] == 8 and header["layers"] == 2

    with pytest.raises(SystemExit, match="geometry mismatch") as got:
        pt_cli.main(["encode", str(tmp_path / "x.tac"), setup["wavs"][0],
                     "--checkpoint", str(tmp_path / "ckpt"), *CPU, "--vertices", "20", "--clip-samples", str(T)])
    # The JAX CLI on a sidecar with the same stamp says the same.
    jax_dir = tmp_path / "jax_ckpt"
    jax_dir.mkdir()
    (jax_dir / "best.extra.json").write_text(json.dumps({"model": setup["model"].geometry()}))
    jargs = argparse.Namespace(checkpoint=str(jax_dir), name=None, vertices=20, bands=None,
                               hidden=None, layers=None)
    with pytest.raises(SystemExit) as want:
        jax_cli._resolve_geometry(jargs, None)
    assert str(got.value) == str(want.value)


def test_geometry_learned_hc_stamp():
    """learned_hc roundtrips geometry() -> _resolve_geometry ->
    _build_model, so a learned-stretch checkpoint restores into the right
    module without CLI flags."""
    model = AudioAutoencoder.create(**TINY, num_samples=T, device="cpu", sampler="hard_concrete",
                                    learned_hc=True)
    header = dict(model.geometry())
    assert header["learned_hc"] is True
    geom = pt_cli._resolve_geometry(argparse.Namespace(checkpoint=None), header)
    assert geom == jax_cli._resolve_geometry(argparse.Namespace(checkpoint=None), header)
    rebuilt = pt_cli._build_model(geom, T, "cpu")
    assert rebuilt.encoder.learned_hc is True and rebuilt.encoder.sampler == "hard_concrete"
    assert rebuilt.state_dict().keys() == model.state_dict().keys()


def test_roundtrip_gran_guard(setup, tmp_path):
    """roundtrip rejects an indivisible --clip-samples up front."""
    with pytest.raises(SystemExit, match="divisible"):
        pt_cli.main(["roundtrip", setup["wavs"][0], str(tmp_path / "x.wav"),
                     "--params", str(setup["root"] / "params"), *GEOM, *CPU, "--clip-samples", "100"])


def test_windowing_arbitrary_length(setup, capsys):
    """A wav longer than the trained clip length is coded as multiple
    windows and reassembled to its original length on decode."""
    root = setup["root"]
    long_wav = root / "long.wav"
    x = np.random.default_rng(5).normal(size=T + T // 2) * 0.1
    save_wav(long_wav, x.astype(np.float32), 16000)

    tac = root / "long.tac"
    pt_cli.main(["encode", str(tac), str(long_wav), "--params", str(root / "params"), *GEOM, *CPU,
                 "--clip-samples", str(T)])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["windows"] == 2  # ceil(1.5 windows)
    _, header = pt_cli.read_tac(tac)
    assert header["files"] == [["long", 2, T + T // 2]]

    out_dir = root / "recon_long"
    pt_cli.main(["decode", str(tac), str(out_dir), "--params", str(root / "params"), *CPU])
    assert len(load_wav(out_dir / "long.wav")) == T + T // 2

    rt = root / "long_rt.wav"
    pt_cli.main(["roundtrip", str(long_wav), str(rt), "--params", str(root / "params"), *GEOM, *CPU,
                 "--clip-samples", str(T)])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["windows"] == 2
    np.testing.assert_array_equal(load_wav(rt), load_wav(out_dir / "long.wav"))


@pytest.fixture(scope="module")
def both(setup, tmp_path_factory):
    """The same wavs encoded by each package's CLI and each file decoded by
    both."""
    root = tmp_path_factory.mktemp("both")
    wavs = setup["wavs"]
    src = setup["root"]
    jax_common = ["--params", str(src / "jax_params"), "--batch", "2"]
    pt_common = ["--params", str(src / "params"), "--batch", "2", *CPU]
    jax_cli.main(["encode", str(root / "jax.tac"), *wavs, *jax_common, *GEOM, "--clip-samples", str(T)])
    pt_cli.main(["encode", str(root / "pt.tac"), *wavs, *pt_common, *GEOM, "--clip-samples", str(T)])
    for tac in ("jax", "pt"):
        jax_cli.main(["decode", str(root / f"{tac}.tac"), str(root / f"{tac}_by_jax"), *jax_common])
        pt_cli.main(["decode", str(root / f"{tac}.tac"), str(root / f"{tac}_by_pt"), *pt_common])
    # The JAX logits of the windows the CLI encodes (the int16 wav reads).
    jm, params = setup["jm"], setup["params"]
    batch, _ = jax_cli._load_windows(wavs, T, 16000)
    logits = jm.apply(params, jnp.asarray(batch), 1.0, None, False,
                      method=lambda m, a, t, r, tr: m.encode(a, t, r, tr)).logits
    return dict(root=root, safe=margin_mask(np.asarray(logits), jm.tables.num_vertices, MARGIN))


def test_headers_are_equal(both):
    _, jh = pt_cli.read_tac(both["root"] / "jax.tac")
    _, ph = jax_cli.read_tac(both["root"] / "pt.tac")
    assert jh == ph
    # The container bytes up to the body: magic, length and JSON header.
    jraw, praw = ((both["root"] / f"{t}.tac").read_bytes() for t in ("jax", "pt"))
    n = 8 + int.from_bytes(jraw[4:8], "little")
    assert jraw[:n] == praw[:n]


def test_bits_are_equal_beyond_the_margin(both):
    jp, _ = pt_cli.read_tac(both["root"] / "jax.tac")
    pp, _ = pt_cli.read_tac(both["root"] / "pt.tac")
    safe = both["safe"]
    assert safe.mean() > 0.9
    bits = [np.unpackbits(p, axis=-1, count=safe.shape[-1]).astype(bool) for p in (jp, pp)]
    np.testing.assert_array_equal(bits[0][safe], bits[1][safe])
    assert bits[0].any()


@pytest.mark.parametrize("tac", ["jax", "pt"])
def test_files_decode_in_both_packages(both, tac):
    """A file written by either CLI decodes in the other to the waveform
    the writer's own package decodes."""
    root = both["root"]
    files = sorted((root / f"{tac}_by_jax").glob("*.wav"))
    assert [f.name for f in files] == ["in_0.wav", "in_1.wav"]
    for f in files:
        got, want = load_wav(root / f"{tac}_by_pt" / f.name), load_wav(f)
        assert got.shape == want.shape == (T,) and np.abs(want).max() > 1e-3
        np.testing.assert_allclose(got, want, rtol=0, atol=WAVE_ATOL + INT16_STEP)


def test_cli_needs_a_card_unless_asked_for_the_cpu(setup, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt_cli.main(["encode", str(tmp_path / "x.tac"), setup["wavs"][0], "--params",
                     str(setup["root"] / "params"), *GEOM, "--clip-samples", str(T)])
    assert not (tmp_path / "x.tac").exists()


def test_packed_tac_decodes_from_the_checkpoint(tmp_path, capsys):
    """A packed model's .tac carries no capacities in its header (as the
    JAX CLI writes it): decode takes them from the checkpoint's sidecar."""
    model = AudioAutoencoder.create(**TINY, num_samples=T, device="cpu", pack_capacities=(0, 0, 6, 3))
    CheckpointManager(tmp_path / "ckpt").save(
        "best", {"params": model.state_dict()}, extra={"model": model.geometry()})
    wav = tmp_path / "a.wav"
    save_wav(wav, waveforms(4, 1, T)[0], 16000)
    ck = ["--checkpoint", str(tmp_path / "ckpt"), *CPU]
    pt_cli.main(["encode", str(tmp_path / "a.tac"), str(wav), *ck, "--clip-samples", str(T)])
    packed, header = pt_cli.read_tac(tmp_path / "a.tac")
    assert "pack_capacities" not in header
    pt_cli.main(["decode", str(tmp_path / "a.tac"), str(tmp_path / "out"), *ck])
    direct = Codec(model, device="cpu").decode(unpack_latent(packed, 5), T).numpy()
    np.testing.assert_allclose(load_wav(tmp_path / "out" / "a.wav"), np.clip(direct[0, 0], -1, 1),
                               atol=INT16_STEP)
