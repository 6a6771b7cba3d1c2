"""The ``train`` kind with one more number in its check,
``grad_turned_share_large``: the share of the large leaves whose first
clipped gradient points more than 45 degrees away from the reference's.

The ``train`` kind compares each leaf's norms. On a bf16 step those move
with the clip's common scale (a few spiky leaves set the global norm, and
every clipped leaf follows it), so a backward that drops one path of a
layer's gradient, as a gather's backward returning zeros does, can leave
every norm inside the spread of sound seeds. An angle is free of that
scale: rounding turns few large leaves by 45 degrees, a dropped path turns
every leaf that it mostly feeds. The leaves are ``check.py``'s large ones
that move (at least ``LARGE_LEAF`` elements, a reference gradient of at
least ``TINY_GRAD`` of the median leaf's). Everything else is the
``train`` kind's: the same traffic, window and readings.
"""

from __future__ import annotations

import math
import statistics

from .. import check, common
from . import train

TURNED_COS = math.cos(math.pi / 4)


def readings(model, batches, temperature: float, seed: int, blocks: int, cast) -> dict:
    """``reference.train.readings``, with the first clipped gradient kept
    whole under ``grads``."""
    from ..reference import train as ref_train

    params = dict(model.named_parameters())
    start = {n: p.detach().clone() for n, p in params.items()}
    adam = ref_train.Adam(params)
    losses, first = [], None
    for step, batch in enumerate(batches):
        parts, grads = ref_train.loss_and_grads(model, batch, temperature, seed, step, blocks, cast)
        grads = adam.clip(grads)
        if first is None:
            first = grads
        adam.apply(grads, params)
        losses.append(parts)
        del grads
    change = ref_train.leaf_norms({n: p.detach() - start[n] for n, p in params.items()})
    return {"losses": losses, "grad_norms": ref_train.leaf_norms(first), "change_norms": change,
            "numel": {n: p.numel() for n, p in params.items()}, "grads": first}


def turned_share(prog: dict, ref: dict) -> tuple:
    """(share, detail) of the large moving leaves whose gradient in
    ``prog["grads"]`` has a cosine under cos 45 degrees with
    ``ref["grads"]``'s."""
    norms = ref["grad_norms"]
    median = statistics.median(norms.values())
    names = [n for n in norms if ref["numel"][n] >= check.LARGE_LEAF and norms[n] >= check.TINY_GRAD * median]
    if not names:
        return float("nan"), None
    turned = []
    for n in names:
        r = ref["grads"][n].detach().double().flatten()
        p = prog["grads"][n].detach().to(r.device).double().flatten()
        denom = float(p.norm()) * float(r.norm())
        if (float(p @ r) / denom if denom > 0 else 0.0) < TURNED_COS:
            turned.append(n)
    return len(turned) / len(names), f"{len(turned)} of {len(names)}"


def train_numbers(prog: dict, ref: dict) -> dict:
    """``check.train_numbers`` and ``grad_turned_share_large``."""
    numbers = check.train_numbers(prog, ref)
    numbers["grad_turned_share_large"] = turned_share(prog, ref)
    return numbers


class Cell(train.Cell):
    def setup(self) -> None:
        super().setup()
        self.readings["grads"] = self.first_grads

    def call_step(self, i: int):
        out = super().call_step(i)
        if i == 0:
            from topo_audio_autoencoder_torch.training import train_step as ts

            # Adam's first moment after one step is the clipped gradient
            # times 1 - b1; on the host, so the window holds no more memory.
            mu = self.state.opt_state.mu
            self.first_grads = {n: (mu[n] / (1.0 - ts.ADAM_B1)).cpu()
                                for n, _ in self.state.model.named_parameters()}
        return out

    def reference_readings(self, control: bool = False) -> dict:
        """The ``train`` kind's, with the first clipped gradient whole."""
        torch = self.torch
        name = self.spec["control"] if control else self.spec["compute_dtype"]
        with common.no_tf32(torch):
            model = common.reference_model(torch, self.cfg, self.seed, self.device)
            batches = [self.corpus[self.idx[s]][:, :, None, :] for s in range(self.traffic["check_steps"])]
            out = readings(model, batches, float(self.temperature), self.seed,
                           self.traffic["check_blocks"], common.precision(torch, name))
        del model
        common.free(torch)
        return out

    def numbers(self, ref: dict) -> dict:
        return train_numbers(self.readings, ref)
