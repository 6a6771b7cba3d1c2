"""The ``train`` traffic kind: ``make_indexed_train_step`` over a device
corpus of clips made from the seed, B x G index groups drawn from the seed,
accumulation 1, at ``anneal_temperature(epoch)``, dispatched back to back.

The first ``check_steps`` steps are set-up; their losses, the first
clipped gradient (Adam's first moment after step 1) and the parameters'
change are read for the check, which the plain reference follows from the
same weights and batches.
"""

from __future__ import annotations

import time

import numpy as np

from .. import check, common, counts, inputs


class Cell:
    unit = "step"

    def __init__(self, torch, cfg: dict, traffic: dict, spec: dict, seed: int, device):
        self.torch, self.cfg, self.traffic, self.spec, self.seed, self.device = torch, cfg, traffic, spec, seed, device
        self.batch, self.group = traffic["batch"], traffic["group"]
        self.k = 0
        self.spans: list = []
        self.profiling = False

    def setup(self) -> None:
        torch, cfg, tr = self.torch, self.cfg, self.traffic
        import topo_audio_autoencoder_torch as port
        from topo_audio_autoencoder_torch.training import train_step as ts

        samples = cfg["model"]["num_samples"]
        self.corpus = inputs.make_clips(tr["corpus_clips"], samples, self.seed, "corpus", self.device)
        idx = inputs.index_groups(tr["corpus_clips"], tr["pool_steps"], self.batch, self.group, self.seed)
        self.idx = torch.as_tensor(idx, device=self.device)
        model = common.program_model(torch, port, cfg, self.seed, self.device)
        optimizer = ts.make_optimizer(accumulate_grad_batches=1)
        self.state = ts.create_train_state(model, optimizer)
        dtype = getattr(torch, self.spec["compute_dtype"])
        self.step = ts.make_indexed_train_step(model, optimizer, self.corpus, compute_dtype=dtype)
        self.temperature = ts.anneal_temperature(tr["temperature_epoch"])
        params = dict(model.named_parameters())
        start = {n: p.detach().clone() for n, p in params.items()}
        losses, grad_norms = [], None
        for s in range(tr["check_steps"]):
            _, metrics = self.call_step(s)
            losses.append({k: float(v) for k, v in metrics.items()})
            if s == 0:
                mu = self.state.opt_state.mu
                grad_norms = check.leaf_norms({n: mu[n] / (1.0 - ts.ADAM_B1) for n in params})
        change = check.leaf_norms({n: p.detach() - start[n] for n, p in params.items()})
        del start
        self.readings = {"losses": losses, "grad_norms": grad_norms, "change_norms": change}
        self.k = tr["check_steps"]

    def call_step(self, i: int):
        return self.step(self.state, self.idx[i % self.idx.shape[0]], self.temperature, self.seed)

    def run(self) -> None:
        t = time.perf_counter()
        self.call_step(self.k)
        if not self.profiling:
            self.spans.append(time.perf_counter() - t)
        self.k += 1

    def window_metrics(self, units: int, window_s: float) -> dict:
        return {self.traffic["rate_metric"]: self.batch * units / window_s,
                "_host_ms_per_step": float(np.mean(self.spans)) * 1e3}

    def after_window(self) -> None:
        """Nothing: the check reads the set-up's steps."""

    def release(self) -> None:
        del self.step, self.state
        common.free(self.torch)

    def reference_readings(self, control: bool = False) -> dict:
        """The plain reference over the same first steps from the same
        weights, in the cell's compute precision with TF32 off; with
        ``control``, in the cell's ``control`` precision."""
        from ..reference import train as ref_train

        torch = self.torch
        name = self.spec["control"] if control else self.spec["compute_dtype"]
        with common.no_tf32(torch):
            model = common.reference_model(torch, self.cfg, self.seed, self.device)
            batches = [self.corpus[self.idx[s]][:, :, None, :] for s in range(self.traffic["check_steps"])]
            out = ref_train.readings(model, batches, float(self.temperature), self.seed,
                                     self.traffic["check_blocks"], common.precision(torch, name))
        del model
        common.free(torch)
        return out

    def numbers(self, ref: dict) -> dict:
        return check.train_numbers(self.readings, ref)

    def flops_per_unit(self) -> float:
        sizes = common.rank_sizes(self.cfg["model"]["num_vertices"])
        return counts.train_step_flops(self.cfg, sizes, self.batch, self.group, common.pqmf_taps(self.cfg))

    def attention_counts(self) -> dict:
        """(FLOPs, bytes) a step of the attention forward and backward:
        the soft latent keeps every key the decoder holds active."""
        m = self.cfg["model"]
        keys = self.batch * sum(common.decoder_rows(self.cfg)[1:])
        q = m["num_samples"] // m["num_bands"] // 16
        elt = common.element_bytes(self.spec["compute_dtype"])
        args = (q, m["sccn_hidden_dim"], counts.ATTENTION_HEADS, keys, keys, self.batch, elt)
        return {"fwd": counts.attention_fwd_counts(*args), "bwd": counts.attention_bwd_counts(*args)}
