"""The port's utils against the JAX package's: each case of
tests/test_utils.py on the port's function, and the helpers' outputs and
messages against JAX's on the same inputs."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topo_audio_autoencoder_torch.utils import (
    assert_finite_tree,
    chain_time,
    checked,
    detect_anomalies,
    fetch_scalar,
    finite_or_zero,
    golden_precision,
    time_fn,
    trace,
    wait_for_backend,
)
from topo_audio_autoencoder_tpu import utils as jax_utils

torch.set_num_threads(1)


def test_time_fn():
    stats = time_fn(lambda x: x @ x.T, torch.ones(64, 64), warmup=1, iters=3)
    assert set(stats) == set(jax_utils.time_fn(jax.jit(lambda x: x @ x.T), jnp.ones((64, 64)), warmup=1, iters=1))
    assert 0 < stats["min"] <= stats["p50"] <= stats["max"]


def test_chain_time_and_fetch_scalar():
    def make_step():
        state = {"x": torch.ones(32, 32)}

        def step(i):
            state["x"] = state["x"] @ state["x"] / 32.0
            return state["x"]

        return step

    assert chain_time(make_step, k1=2, k2=4, warmup=1) > 0
    assert fetch_scalar({"a": torch.full((4, 4), 2.0), "b": (torch.tensor([3.0, 1.0]),)}) == 3.0


def test_detect_anomalies_scoped():
    before = torch.is_anomaly_enabled()
    with detect_anomalies():
        assert torch.is_anomaly_enabled() is True
        with pytest.raises(FloatingPointError):
            torch.log(torch.tensor(-1.0)) * 1.0
    assert torch.is_anomaly_enabled() == before
    torch.log(torch.tensor(-1.0))  # outside the scope: no check


def test_detect_anomalies_checks_the_forward_and_infs():
    with detect_anomalies(nans=False):
        torch.log(torch.tensor(-1.0))  # NaN, not checked
        with pytest.raises(FloatingPointError, match="inf"):
            torch.tensor(1.0) / torch.tensor(0.0)
    x = torch.tensor([1.0, 0.0], requires_grad=True)
    with detect_anomalies(), pytest.raises(FloatingPointError, match="nan"):
        (torch.sqrt(x - 0.5) * x).sum()


def test_assert_finite_tree():
    assert_finite_tree({"a": torch.ones(3)}, "ok")
    with pytest.raises(FloatingPointError, match="bad") as got:
        assert_finite_tree({"x": torch.tensor([1.0, np.nan])}, "bad")
    with pytest.raises(FloatingPointError) as want:
        jax_utils.assert_finite_tree({"x": jnp.array([1.0, np.nan])}, "bad")
    assert str(got.value) == str(want.value)


def test_checked_catches_nan():
    def bad(x):
        return torch.log(x)  # nan for negative input

    f = checked(bad)
    np.testing.assert_allclose(f(torch.tensor(1.0)).numpy(), 0.0)
    with pytest.raises(Exception, match="nan"):
        f(torch.tensor(-1.0))


def test_checked_catches_indices_and_integer_division():
    x = torch.arange(5.0)
    with pytest.raises(IndexError, match="out-of-bounds"):
        checked(lambda i: torch.gather(x, 0, i))(torch.tensor([0, 5]))
    with pytest.raises(IndexError, match="out-of-bounds"):
        checked(lambda i: x[i])(torch.tensor([-6]))
    assert float(checked(lambda i: x[i])(torch.tensor([-5]))[0]) == 0.0  # negative indices wrap
    with pytest.raises(ZeroDivisionError):
        checked(lambda d: torch.tensor([4, 2]) // d)(torch.tensor([2, 0]))
    np.testing.assert_array_equal(checked(lambda i: x.index_select(0, i), errors={"index"})(torch.tensor([4])), [4.0])
    with pytest.raises(ValueError, match="unknown checks"):
        checked(lambda: None, errors={"overflow"})


def test_golden_precision_scoped():
    before = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    with golden_precision():
        assert torch.get_float32_matmul_precision() == "highest"
        assert torch.backends.cuda.matmul.allow_tf32 is False and torch.backends.cudnn.allow_tf32 is False
    assert (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == before


def test_finite_or_zero():
    x = np.array([1.0, np.inf, np.nan, -2.0], np.float32)
    got = finite_or_zero(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, [1.0, 0.0, 0.0, -2.0])
    np.testing.assert_array_equal(got, np.asarray(jax_utils.finite_or_zero(jnp.asarray(x))))


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "t")) as d:
        (torch.ones(8, 8) @ torch.ones(8, 8)).sum()
    events = json.loads((tmp_path / "t" / "trace.json").read_text())["traceEvents"]
    assert d == str(tmp_path / "t") and any("mm" in e.get("name", "") for e in events)


def test_wait_for_backend_reachable():
    """A healthy backend is detected on the first subprocess probe."""
    assert wait_for_backend(120.0, platform="cpu", probe_timeout=90.0)


def test_wait_for_backend_unreachable_gives_up():
    msgs = []
    assert not wait_for_backend(
        12.0, platform="no_such_platform", poll=1.0, probe_timeout=30.0,
        log=msgs.append,
    )
    assert any("unreachable" in m for m in msgs)
