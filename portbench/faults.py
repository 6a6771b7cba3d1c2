"""Faults planted in the program for the tests of the check and for
``calibrate.py``: each breaks the timed path underneath the harness, which
runs unchanged. The benchmark's own runs never plant one.

- ``frozen``: the optimizer applies no update (a step that returns its
  state unchanged);
- ``half_batch``: the train step sees the first half of each step's index
  groups, the mean taken over them;
- ``altered``: the codec answers each request's first clip with its second
  clip's waveform;
- ``attn_dq_dropped``: the attention backward (rows 1-2) returns no
  gradient for the queries;
- ``attn_dkdv_dropped``: it returns none for the keys and values.
"""

from __future__ import annotations

import contextlib
from unittest import mock

NAMES = ("frozen", "half_batch", "altered", "attn_dq_dropped", "attn_dkdv_dropped")


@contextlib.contextmanager
def plant(name: str):
    """Inside, the port runs with fault ``name``."""
    from topo_audio_autoencoder_torch import inference
    from topo_audio_autoencoder_torch.ops import attention
    from topo_audio_autoencoder_torch.training import train_step as ts

    if name == "frozen":
        make = ts.make_optimizer

        def make_frozen(*args, **kwargs):
            optimizer = make(*args, **kwargs)
            optimizer.update = lambda grads, state, model: False
            return optimizer

        patch = mock.patch.object(ts, "make_optimizer", make_frozen)
    elif name == "half_batch":
        make = ts.make_indexed_train_step

        def make_half(*args, **kwargs):
            step = make(*args, **kwargs)
            return lambda state, idxs, *a, **k: step(state, idxs[: idxs.shape[0] // 2], *a, **k)

        patch = mock.patch.object(ts, "make_indexed_train_step", make_half)
    elif name == "altered":
        decode = inference.Codec.decode

        def decode_altered(self, latent, num_samples):
            wave = decode(self, latent, num_samples).clone()
            wave[0] = wave[1]
            return wave

        patch = mock.patch.object(inference.Codec, "decode", decode_altered)
    elif name in ("attn_dq_dropped", "attn_dkdv_dropped"):
        backward = attention.MaskedAttention.backward

        def backward_dropped(ctx, dout, dlse):
            dq, dk, dv, *rest = backward(ctx, dout, dlse)
            if name == "attn_dq_dropped":
                dq = dq * 0
            else:
                dk, dv = dk * 0, dv * 0
            return (dq, dk, dv, *rest)

        patch = mock.patch.object(attention.MaskedAttention, "backward", staticmethod(backward_dropped))
    else:
        raise ValueError(f"no fault {name!r}; one of {NAMES}")
    with patch:
        yield
