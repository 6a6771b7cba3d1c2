"""The PyTorch port, its examples, its tools and chip_smoke.py import
neither JAX nor the JAX package, and chip_smoke.py refuses to run without
a card."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "topo_audio_autoencoder_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "topo_audio_autoencoder_tpu")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_port_modules_do_not_import_jax():
    modules = sorted(
        "topo_audio_autoencoder_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py")
    )
    modules = [m.removesuffix(".__init__") for m in modules]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=_env(), timeout=300
    )
    assert proc.returncode == 0, proc.stderr
    assert len(modules) >= 15
    for kernel_module in ("attention", "fused_samplers", "fused_hard_concrete", "sccn_combine", "combine_diag"):
        assert f"topo_audio_autoencoder_torch.ops.{kernel_module}" in modules
    assert "topo_audio_autoencoder_torch.topology.packed" in modules


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_port_source_names_jax():
    examples = sorted((ROOT / "examples").glob("torch_*.py"))
    assert [p.name for p in examples] == ["torch_codec_roundtrip.py", "torch_train_synthetic.py"]
    for path in [ROOT / "chip_smoke.py", *PORT.rglob("*.py"), *examples, *(ROOT / "tools").glob("*.py")]:
        assert not _imported_roots(path) & set(FORBIDDEN), path


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run in full")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")],
        capture_output=True, text=True, env=_env(), timeout=300, cwd=tmp_path,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_kernel_build_digest_covers_sources_and_shared_headers(tmp_path, monkeypatch):
    """An edit to a kernel's source or to a shared csrc/*.cuh header gives a
    new library path, so a stale build is never loaded; every kernel of
    KERNELS has its source, and the two samplers share philox.cuh."""
    import shutil

    from topo_audio_autoencoder_torch import cuda_build

    assert {p.stem for p in cuda_build.CSRC.glob("*.cu")} == set(cuda_build.KERNELS)
    for name in ("binary_gumbel", "hard_concrete"):
        assert '#include "philox.cuh"' in (cuda_build.CSRC / f"{name}.cu").read_text()
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, csrc)
    monkeypatch.setattr(cuda_build, "CSRC", csrc)
    before = cuda_build.library_path("hard_concrete")
    assert before == cuda_build.library_path("hard_concrete")
    (csrc / "philox.cuh").write_text((csrc / "philox.cuh").read_text() + "\n// edited\n")
    after_header = cuda_build.library_path("hard_concrete")
    assert after_header != before
    (csrc / "hard_concrete.cu").write_text((csrc / "hard_concrete.cu").read_text() + "\n// edited\n")
    assert cuda_build.library_path("hard_concrete") not in (before, after_header)
