"""PyTorch port vs the JAX package: the data layer's host side. The
synthetic corpus, WAV I/O and preprocessing, the native runtime (built by
the port into ``_build/``) and its plain versions, the contrastive dataset,
its iterators and ``prefetch_to_device`` on the CPU, and the neighbor
explorer. Everything here is NumPy or the same C++ source on both sides,
so every comparison is bit for bit unless it says otherwise."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from topo_audio_autoencoder_torch import data as pt
from topo_audio_autoencoder_torch.data import native_loader as pt_native
from topo_audio_autoencoder_tpu import data as jx
from topo_audio_autoencoder_tpu.data import native_loader as jx_native

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
N, T = 20, 256


@pytest.fixture(scope="module")
def corpus():
    return np.random.default_rng(0).standard_normal((N, T)).astype(np.float32)


@pytest.fixture(scope="module")
def neighbors():
    rng = np.random.default_rng(1)
    return np.stack([rng.permutation(np.delete(np.arange(N), i)) for i in range(N)]).astype(np.int32)


def test_synthetic_corpus_equal_bits():
    np.testing.assert_array_equal(pt.synth_corpus(3, 4096, seed=5), jx.synth_corpus(3, 4096, seed=5))
    np.testing.assert_array_equal(
        pt.synth_note(np.random.default_rng(9), 2000, 32000), jx.synth_note(np.random.default_rng(9), 2000, 32000)
    )


def _write_wavs(d: Path) -> list:
    """Five WAVs: 16 kHz mono int16, 32 kHz mono int16, 16 kHz stereo
    int16, 8-bit unsigned, and 64-bit float (which the native parser
    refuses, so scipy decodes it)."""
    x = pt.synth_corpus(1, 3000, seed=1)[0]
    pt.save_wav(d / "a_16k.wav", x, 16000)
    pt.save_wav(d / "b_32k.wav", pt.synth_note(np.random.default_rng(2), 7000, 32000), 32000)
    wavfile.write(d / "c_stereo.wav", 16000, (np.stack([x, -0.5 * x], 1) * 32767).astype(np.int16))
    wavfile.write(d / "d_u8.wav", 16000, (x * 127 + 128).astype(np.uint8))
    wavfile.write(d / "e_f64.wav", 16000, x.astype(np.float64))
    return sorted(d.glob("*.wav"))


def test_wav_roundtrip_and_resample(tmp_path):
    """save_wav then load_wav against the JAX package's, on each file kind;
    an int16 round trip within 1e-3 (16-bit quantization, as
    tests/test_data.py), a 2:1 resample halves the length."""
    for p in _write_wavs(tmp_path):
        np.testing.assert_array_equal(pt.load_wav(p), jx.load_wav(p), err_msg=p.name)
    x = np.sin(np.linspace(0, 100, 4000)).astype(np.float32) * 0.5
    pt.save_wav(tmp_path / "t.wav", x, 16000)
    assert (tmp_path / "t.wav").read_bytes() == _jax_saved(tmp_path, x, 16000)
    np.testing.assert_allclose(pt.load_wav(tmp_path / "t.wav"), x, atol=1e-3)
    pt.save_wav(tmp_path / "t32.wav", np.resize(x, 8000), 32000)
    assert pt.load_wav(tmp_path / "t32.wav", 16000).shape == (4000,)


def _jax_saved(tmp_path, x, sr) -> bytes:
    jx.save_wav(tmp_path / "jax.wav", x, sr)
    return (tmp_path / "jax.wav").read_bytes()


def test_native_decode_matches_jax_module_and_refuses_float64(tmp_path):
    paths = _write_wavs(tmp_path)
    for p in paths:
        got = pt_native.load_wav_native(p, 4000, 16000)
        want = jx_native.load_wav_native(p, 4000, 16000)
        if p.name == "e_f64.wav":
            assert got is None and want is None
        else:
            np.testing.assert_array_equal(got, want, err_msg=p.name)


def test_preprocess_split_matches_jax(tmp_path):
    """The packed array, the .npy and the manifest against the JAX
    package's, on WAVs of every kind (native decode first, scipy for the
    float64 file); load_split memory-maps what preprocess_split wrote."""
    paths = _write_wavs(tmp_path / "wavs")
    got = pt.preprocess_split(paths, tmp_path / "pt", "train", 16000, 3200)
    want = jx.preprocess_split(paths, tmp_path / "jx", "train", 16000, 3200)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (5, 3200)
    for name in ("train.npy", "train_manifest.json"):
        assert (tmp_path / "pt" / name).read_bytes() == (tmp_path / "jx" / name).read_bytes()
    loaded = pt.load_split(tmp_path / "pt", "train")
    assert isinstance(loaded, np.memmap)
    np.testing.assert_array_equal(loaded, want)
    np.testing.assert_array_equal(
        pt.load_split(tmp_path / "pt", "train", mmap=False), jx.load_split(tmp_path / "jx", "train", mmap=False)
    )


def test_native_gather_and_assembly_match_jax(corpus, neighbors):
    """The native gather and contrastive assembly (the library's own
    xorshift stream) against the JAX module's, bit for bit; the port's
    plain versions against JAX's plain versions and against the native
    ones where the RNG does not enter (num_pos = 1)."""
    idx = np.array([3, 5, 3, 19, 0], dtype=np.int32)
    np.testing.assert_array_equal(pt_native.gather_batch(corpus, idx), jx_native.gather_batch(corpus, idx))
    np.testing.assert_array_equal(pt_native._gather_numpy(corpus, idx), corpus[idx])
    anchors = np.arange(7, dtype=np.int32)
    for args in ((3, 4, 19, 42), (1, 3, 10, 7), (5, 6, 2, 11)):
        got = pt_native.assemble_contrastive_batch(corpus, anchors, neighbors, *args, num_threads=3)
        np.testing.assert_array_equal(got, jx_native.assemble_contrastive_batch(corpus, anchors, neighbors, *args))
        np.testing.assert_array_equal(
            pt_native._assemble_numpy(corpus, anchors, neighbors, *args),
            jx_native._assemble_numpy(corpus, anchors, neighbors, *args),
        )
    np.testing.assert_array_equal(
        pt_native.assemble_contrastive_batch(corpus, anchors, neighbors, 1, 3, 10, 7),
        pt_native._assemble_numpy(corpus, anchors, neighbors, 1, 3, 10, 7),
    )
    with pytest.raises(IndexError):
        pt_native.gather_batch(corpus, np.array([N], dtype=np.int32))


def test_native_library_is_built_into_build_dir_and_never_the_tracked_one():
    """In a fresh process: the port's library comes from _build/ under a
    digest of source and flags, with no -march=native, and the tracked
    native/libtaa_audio.so is never mapped."""
    code = (
        "import numpy as np\n"
        "from topo_audio_autoencoder_torch.data import native_loader as n\n"
        "n.gather_batch(np.zeros((2, 4), np.float32), np.array([1], np.int32))\n"
        "print(n.get_lib()._name)\n"
        "print(open('/proc/self/maps').read())\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    name, maps = proc.stdout.split("\n", 1)
    assert Path(name) == pt_native.library_path()
    assert Path(name).parent == ROOT / "topo_audio_autoencoder_torch" / "_build"
    assert str(ROOT / "native" / "libtaa_audio.so") not in maps
    assert name in maps
    assert not any("march" in f for f in pt_native.CXX_FLAGS)


def test_native_build_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    """A source that does not compile raises with the compiler's stderr;
    an edited source gets a new library path."""
    broken = tmp_path / "broken.cpp"
    broken.write_text('extern "C" int taa_load_wav( { }\n')
    monkeypatch.setattr(pt_native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="error"):
        pt_native.build(broken)
    edited = tmp_path / "edited.cpp"
    edited.write_text(pt_native.SOURCE.read_text() + "\n// edited\n")
    assert pt_native.library_path(edited) != pt_native.library_path(pt_native.SOURCE)
    assert not list((tmp_path / "_build").glob("*.so"))


def _datasets(corpus, neighbors, train=True, **cfg):
    return (
        pt.NSynthDataset(corpus, neighbors, train=train, config=pt.ContrastiveConfig(**cfg), seed=3),
        jx.NSynthDataset(corpus, neighbors, train=train, config=jx.ContrastiveConfig(**cfg), seed=3),
    )


def test_dataset_items_and_curriculum_match_jax(corpus, neighbors):
    """__getitem__ (train: the dataset's own RNG stream; eval), the group
    size and the x0.90 curriculum with its floor, clamped to the neighbor
    range, epoch by epoch."""
    p, j = _datasets(corpus, neighbors, num_positive_neighbors=3, num_negative_samples=4, min_negative_offset=5)
    assert p.group_size == j.group_size == 6 and len(p) == len(j) == N
    for epoch in (0, 1, 4, 10, 100):
        p.set_epoch(epoch)
        j.set_epoch(epoch)
        assert p.current_negative_offset == j.current_negative_offset
        for i in (0, 7, 19):
            np.testing.assert_array_equal(p[i], j[i])
    assert p.current_negative_offset == 5
    pe, je = _datasets(corpus, None, train=False)
    assert pe.group_size == 1
    np.testing.assert_array_equal(pe[4], je[4])
    with pytest.raises(ValueError, match="neighbor ordering"):
        pt.NSynthDataset(corpus, None, train=True)


@pytest.mark.parametrize(
    "cfg, epoch",
    [
        (dict(num_positive_neighbors=3, num_negative_samples=4), 0),
        (dict(num_negative_samples=1), 1),
        # a window shorter than num_negative_samples: the edge pad
        (dict(num_negative_samples=4, min_negative_offset=2), 100),
    ],
)
def test_sample_batch_indices_and_batches_match_jax(corpus, neighbors, cfg, epoch):
    p, j = _datasets(corpus, neighbors, **cfg)
    p.set_epoch(epoch)
    j.set_epoch(epoch)
    anchors = np.array([0, 5, 9, 19])
    for seed in (7, 8):
        got = p.sample_batch_indices(anchors, seed)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, j.sample_batch_indices(anchors, seed))
        np.testing.assert_array_equal(p.sample_batch(anchors, seed), j.sample_batch(anchors, seed))
    pe, je = _datasets(corpus, None, train=False)
    np.testing.assert_array_equal(pe.sample_batch_indices(anchors, 7), je.sample_batch_indices(anchors, 7))
    np.testing.assert_array_equal(pe.sample_batch(anchors, 7), je.sample_batch(anchors, 7))


def test_sample_batch_indices_empty_window_raises_as_jax(corpus, neighbors):
    p, j = _datasets(corpus, neighbors, num_negative_samples=2, min_negative_offset=0)
    p.set_epoch(1000)
    j.set_epoch(1000)
    assert p.current_negative_offset == 0
    for ds in (p, j):
        with pytest.raises(ValueError, match="empty negative window"):
            ds.sample_batch_indices(np.array([1, 2]), 3)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("shuffle, drop", [(True, True), (False, False)])
def test_batch_and_index_iterators_match_jax(corpus, neighbors, train, shuffle, drop):
    """Every batch of batch_iterator and index_iterator, for two epochs
    (the shuffle order and the per-batch seed seed + epoch * 100003 +
    start), and index_iterator's rows gathered equal batch_iterator's."""
    p, j = _datasets(corpus, neighbors if train else None, train=train, num_negative_samples=3)
    for epoch in (0, 2):
        kw = dict(shuffle=shuffle, seed=11, epoch=epoch, drop_remainder=drop)
        got = list(pt.batch_iterator(p, 6, **kw))
        want = list(jx.batch_iterator(j, 6, **kw))
        assert len(got) == len(want) == (3 if drop else 4)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        got_idx = list(pt.index_iterator(p, 6, **kw))
        for a, b, batch in zip(got_idx, jx.index_iterator(j, 6, **kw), got):
            np.testing.assert_array_equal(a, b)
            gathered = corpus[a][:, :, None, :] if train else corpus[a[:, 0]][:, None, :]
            np.testing.assert_array_equal(gathered, batch)


def test_prefetch_to_device_on_the_cpu_matches_jax(corpus, neighbors):
    """On the CPU: every batch equals the JAX package's prefetch (through
    jax.device_put), as a CPU tensor that is not pinned; a custom put is
    used as given."""
    p, j = _datasets(corpus, neighbors, num_negative_samples=2)
    got = list(pt.prefetch_to_device(pt.batch_iterator(p, 4, seed=5), size=2, device="cpu"))
    want = list(jx.prefetch_to_device(jx.batch_iterator(j, 4, seed=5), size=2))
    assert len(got) == len(want) == N // 4
    for a, b in zip(got, want):
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu" and not a.is_pinned()
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    seen = list(pt.prefetch_to_device(iter(range(5)), size=3, put=lambda x: x * 10))
    assert seen == [0, 10, 20, 30, 40]


def test_prefetch_to_device_defaults_to_the_card(corpus):
    """With no device and no card, the default placement raises rather
    than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default placement would use it")
    ds = pt.NSynthDataset(corpus, train=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(pt.prefetch_to_device(pt.batch_iterator(ds, 4)))


def test_explore_neighbors_tree_matches_jax(tmp_path, corpus, neighbors):
    """The same directory tree, file names and WAV bytes, for a chosen
    index and for one drawn from the seed."""
    rng = np.random.default_rng(4)
    distances = rng.uniform(0.1, 5.0, (N, N)).astype(np.float32)
    wav = corpus / (np.abs(corpus).max() * 1.1)
    for index in (7, None):
        got = pt.explore_neighbors(wav, distances, neighbors, index, tmp_path / "pt", 3, seed=2)
        want = jx.explore_neighbors(wav, distances, neighbors, index, tmp_path / "jx", 3, seed=2)
        assert got.name == want.name
        files = sorted(p.relative_to(got) for p in got.rglob("*.wav"))
        assert files == sorted(p.relative_to(want) for p in want.rglob("*.wav"))
        assert len(files) == 7
        for f in files:
            assert (got / f).read_bytes() == (want / f).read_bytes(), f
