"""The hand-written CUDA kernels against their plain torch versions, on the
card. Without a CUDA card every test here skips (the CPU has no kernel to
run: the wrappers take the plain version for CPU tensors, which the other
test_torch_* files hold against the JAX package).

Run on the card with ``python -m pytest tests/test_torch_kernels.py -q``.
"""

import numpy as np
import pytest
import torch

from topo_audio_autoencoder_torch.ops import attention

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# fp32: both sides compute in fp32 and differ only in summation order.
# bf16: both round the fp32 output to bf16 once; one bf16 ulp at |o| <= 4.
TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -6}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(3, 20, 200, 8, 2), (4, 250, 1000, 64, 4)], ids=["small", "d16"])
def test_attention_kernel_matches_plain(cuda, dtype, shape):
    b, q, m, c, h = shape
    rng = np.random.default_rng(0)
    query, keys, values = (
        torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda, dtype)
        for s in ((b, q, c), (b, m, c), (b, m, c))
    )
    mask = torch.from_numpy((rng.uniform(size=(b, m)) < 0.4).astype(np.float32)).to(cuda)
    mask[0] = 0.0
    mask[1] = 0.0
    mask[1, m // 3] = 1.0
    before = attention.attention_fwd.launches
    out, lse = attention.attention_fwd(query, keys, values, mask, h)
    torch.cuda.synchronize()
    assert attention.attention_fwd.launches == before + 1
    want, want_lse = attention.attention_fwd_plain(query, keys, values, mask, h)
    assert out.dtype == dtype and out.shape == query.shape
    assert (out[0] == 0).all() and torch.isinf(lse[0]).all()
    err = (out.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype], err
    torch.testing.assert_close(lse[1:], want_lse[1:], rtol=1e-5, atol=1e-5)


def test_attention_kernel_refuses_gradients(cuda):
    q = torch.zeros(1, 4, 8, device=cuda, requires_grad=True)
    k = torch.zeros(1, 5, 8, device=cuda)
    with pytest.raises(NotImplementedError, match="training slice"):
        attention.fused_masked_attention(q, k, k, torch.ones(1, 5, device=cuda), 2)
