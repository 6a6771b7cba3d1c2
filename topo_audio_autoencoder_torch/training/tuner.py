"""Vmapped hyperparameter grid search: every combo trains at once.

Port of ``topo_audio_autoencoder_tpu.training.tuner``. The grid (encoder_lr
x decoder_lr x complexity_penalty) becomes a vmapped leading axis: K
parameter sets stacked leaf by leaf to [K, ...], K Adam states, K
hyperparameter scalars, and one step that advances all combos on the same
batch.

- The loss is ``torch.func.functional_call`` of the model over the stacked
  parameters, ``torch.func.vmap``-ed over the combos, summed, and
  differentiated by one backward: JAX's grad-of-vmap. Each combo's loss
  depends only on its own parameters, so the gradient of the sum is the
  stack of the per-combo gradients. The custom autograd Functions on the
  path (the masked attention, the decoder's resizes, the rectifier's face
  gather) fold the vmapped axis into their own batch axis, so the
  attention's forward and backward kernels each launch once a grid step,
  over K*B elements.
- Randomness stays outside the vmap (``randomness="error"``): each combo's
  sampler uniforms, dropout uniforms and, for a ``hard`` model, Bernoulli
  uniforms are drawn before it from that combo's own generators, which
  derive from (seed, combo, step) alone, and go in as batched inputs.
- The optimizer is optax's ``chain(clip_by_global_norm, scale_by_adam)``
  per combo, on the stacked leaves: each combo's gradient is clipped by
  its own global norm, and its normalized update is scaled by ``-lr_e``
  for parameters named ``encoder.*`` and ``-lr_d`` for the rest, exactly
  two-group Adam. Bias corrections in fp32, as the train step's.
- The spectral term uses ``stft_method="matmul"``, as the JAX tuner does.
- ``scan_grid_step`` is a Python loop of grid steps whose losses stack to
  [k, K]. The noise of a step derives from (seed, combo, step counter), so
  the scanned and the per-step tune are equal bit for bit.
- ``mesh`` (a ``parallel.DataMesh``) tunes data-parallel, as the
  production step runs: the grid state is broadcast from rank 0, each rank
  takes its rows of every batch, every combo's noise is drawn at the global
  batch's shape and cut to the rank's rows, the stacked gradients and
  losses are averaged over the ranks by one all-reduce before the update,
  and ``grid_eval``'s losses by another. Every rank advances all K combos.

The sequential, per-combo-resumable tuner remains in
``Trainer.tune_hyperparameters``.
"""

from __future__ import annotations

import copy
import itertools
from dataclasses import dataclass

import numpy as np
import torch
import torch.utils._pytree as pytree
from torch import nn

from ..models.autoencoder import AudioAutoencoder
from ..models.encoder import info_nce_loss, rank_diversity_entropy, vertex_count_penalty
from ..ops.samplers import rand_rows, uniform_noise
from ..parallel import mean_over_ranks, replicate, row_shard, shard_batch
from .losses import LossWeights, autoencoder_loss
from .train_step import (
    OptState,
    adam_update,
    anneal_temperature,
    bias_corrections,
    device_corpus,
    gather_batch,
    step_generators,
)


@dataclass
class GridState:
    """K-stacked parameters ({name: [K, ...]}, fp32), their Adam moments
    (an ``OptState`` of [K, ...] leaves; the update count is shared), the
    per-combo hyperparameters [K] and the grid-step counter."""

    params: dict
    opt_state: OptState
    encoder_lr: torch.Tensor
    decoder_lr: torch.Tensor
    complexity_penalty: torch.Tensor
    step: int = 0


def _grid_combos(grid: dict) -> list[tuple[float, float, float]]:
    return list(
        itertools.product(
            grid["encoder_lr"], grid["decoder_lr"], grid["complexity_penalty"]
        )
    )


def combo_seeds(seed: int, k: int) -> list[tuple[int, int]]:
    """(weights seed, step seed) of each of ``k`` combos: a function of
    (seed, combo) alone."""
    return [
        tuple(int(s) for s in np.random.SeedSequence([seed, i]).generate_state(2, np.uint64))
        for i in range(k)
    ]


class _ComboObjective(nn.Module):
    """One combo's train loss, the JAX tuner's ``loss_fn``: every clip
    through PQMF and ``compute_logits``, InfoNCE on fp32 logits when
    G >= 3, the anchors sampled, rectified and decoded, the complexity
    penalty a (vmapped) tensor. Its randomness comes in as tensors."""

    def __init__(self, model: AudioAutoencoder, weights: LossWeights):
        super().__init__()
        self.model = model
        self.weights = weights

    def forward(self, batch, temperature, compute_dtype, cpx, noise, dropout_noise, hard_noise):
        model = self.model
        b, g, _, t = batch.shape
        flat = batch.reshape(b * g, 1, t).to(compute_dtype)
        bands = model.pqmf(flat)
        logits = model.encoder.compute_logits(bands.transpose(-1, -2), True, dropout_noise=dropout_noise)
        contrastive = info_nce_loss(logits.reshape(b, g, -1).to(torch.float32)) if g >= 3 else None
        enc = model.encoder.generate_complex(
            logits.reshape(b, g, -1)[:, 0], temperature, True, noise=noise, hard_noise=hard_noise
        )
        recon = model.decode(enc, t // model.num_bands, True)
        aux = {
            "binary_entropy": rank_diversity_entropy(enc.rectified),
            "diversity": vertex_count_penalty(
                enc.rectified.vertices, model.min_active_vertices, model.max_active_vertices
            ),
        }
        total, _ = autoencoder_loss(
            recon.to(torch.float32),
            flat.reshape(b, g, 1, t)[:, 0].to(torch.float32),
            {k: v.to(torch.float32) for k, v in aux.items()},
            enc.valid,
            self.weights._replace(complexity_penalty=cpx),
            contrastive,
            stft_method="matmul",
        )
        return total


class _ComboEval(nn.Module):
    """One combo's eval loss: the deterministic forward and the loss."""

    def __init__(self, model: AudioAutoencoder, weights: LossWeights):
        super().__init__()
        self.model = model
        self.weights = weights

    def forward(self, batch, cpx):
        out = self.model(batch, 1.0, train=False)
        total, _ = autoencoder_loss(
            out.waveform, batch, out.aux, out.valid, self.weights._replace(complexity_penalty=cpx),
            stft_method="matmul",
        )
        return total


def _per_combo(v: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """A [K] vector shaped to broadcast over a [K, ...] leaf."""
    return v.reshape(-1, *([1] * (leaf.dim() - 1)))


class VmappedGridTuner:
    def __init__(
        self,
        model: AudioAutoencoder,
        gradient_clip_val: float = 10.0,
        compute_dtype: torch.dtype = torch.float32,
        weights: LossWeights = LossWeights(),
        mesh=None,
    ):
        """The tuner works on its own copy of ``model`` (the caller's
        parameters are neither used nor changed). ``mesh``: the data mesh
        to tune over (every batch this rank's rows, the grid replicated)."""
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, not {compute_dtype}")
        model = copy.deepcopy(model)
        # vmapping the whole grid over the train step can't lower the
        # fused samplers' pallas_call (the scalar SMEM seed block has no
        # batched block mapping); run the tuner with the pure-JAX
        # samplers — the flag carries no params, so the winning combo's
        # weights transfer to the fused-sampler production model as-is.
        # (The JAX package's reason; the port keeps the decision, and its
        # plain samplers take each combo's uniforms as a vmapped input.)
        model.encoder.use_fused_sampler = False
        self.model = model
        self.mesh = mesh
        self.device = next(model.parameters()).device
        self.base_weights = weights
        self.max_norm = gradient_clip_val
        self.compute_dtype = compute_dtype
        self._objective = _ComboObjective(model, weights)
        self._eval = _ComboEval(model, weights)

    # ------------------------------------------------------------ state

    def init_grid(self, grid: dict, sample_shape=None, seed: int = 511990) -> GridState:
        """K independently seeded parameter sets (``reset_parameters`` from
        each combo's weights seed) + per-combo hyperparameters.
        ``sample_shape`` is accepted for the JAX signature; the port's
        parameter shapes are fixed at ``create``."""
        combos = _grid_combos(grid)
        models = []
        for init_seed, _ in combo_seeds(seed, len(combos)):
            m = copy.deepcopy(self.model)
            m.reset_parameters(init_seed)
            models.append(m)
        params, _ = torch.func.stack_module_state(models)
        params = {n: p.detach() for n, p in params.items()}
        del models
        enc, dec, cpx = (
            torch.tensor([c[i] for c in combos], dtype=torch.float32, device=self.device) for i in range(3)
        )
        opt_state = OptState(
            mu={n: torch.zeros_like(p) for n, p in params.items()},
            nu={n: torch.zeros_like(p) for n, p in params.items()},
        )
        state = GridState(params, opt_state, enc, dec, cpx)
        return state if self.mesh is None else replicate(state, self.mesh)

    # ------------------------------------------------------------ noise

    def draw_noise(self, batch_shape, seed: int, step: int, k: int) -> dict:
        """Each combo's uniforms for the grid step ``step``, stacked to
        [K, ...]: the sampler's ("noise", [K, B, S]), the two dropout
        layers' ("dropout", [K, B*G, 2048] and [K, B*G, 1024]; absent when
        dropout is off) and, for a ``hard`` model, the four per-rank
        Bernoulli draws ("hard"). Combo i draws them from
        ``step_generators(step seed of i, step)`` in the order the train
        step's single-combo path draws from the same generators. With a
        mesh, ``batch_shape`` is this rank's and each draw is its rows of
        the global batch's draw."""
        b, g = batch_shape[:2]
        enc = self.model.encoder
        shard = row_shard(self.mesh)
        noise, drop0, drop1, hard = [], [], [], []
        for _, step_seed in combo_seeds(seed, k):
            sample_gen, dropout_gen = step_generators(step_seed, step, self.device)
            if enc.dropout > 0.0:
                for drop, width in ((drop0, enc.mlp0.out_features), (drop1, enc.mlp1.out_features)):
                    drop.append(rand_rows((b * g, width), dropout_gen, shard))
            noise.append(uniform_noise((b, enc.total_simplices), sample_gen, self.device, shard))
            if enc.hard:
                hard.append([rand_rows((b, n), dropout_gen, shard) for n in enc.sizes])
        out = {"noise": torch.stack(noise)}
        if drop0:
            out["dropout"] = (torch.stack(drop0), torch.stack(drop1))
        if hard:
            out["hard"] = [torch.stack(r) for r in zip(*hard)]
        return out

    # ------------------------------------------------------------ steps

    def loss_and_grads(self, state: GridState, batch, temperature, seed: int = 0, noise=None):
        """The grid's per-combo train losses [K] and their gradients
        ({name: [K, ...]}, fp32), without the update. ``noise`` (a dict as
        ``draw_noise`` returns it; "dropout" and "hard" only where the model
        draws them) replaces the combos' draws. With a mesh, ``batch`` and
        ``noise`` are this rank's rows, and the losses and gradients come
        back averaged over the ranks."""
        batch = torch.as_tensor(batch, device=self.device)
        if noise is None:
            noise = self.draw_noise(batch.shape, seed, state.step, state.encoder_lr.shape[0])
        noise = pytree.tree_map(lambda u: torch.as_tensor(u, device=self.device), noise)
        leaves = {n: p.detach().requires_grad_() for n, p in state.params.items()}
        cast = {f"model.{n}": p.to(self.compute_dtype) for n, p in leaves.items()}
        objective, dtype, temp = self._objective, self.compute_dtype, float(temperature)

        def combo_loss(params, cpx, inputs):
            drop = inputs.get("dropout")
            return torch.func.functional_call(
                objective, params,
                (batch, temp, dtype, cpx, inputs["noise"], tuple(drop) if drop is not None else None,
                 inputs.get("hard")),
            )

        losses = torch.func.vmap(combo_loss, randomness="error")(cast, state.complexity_penalty, noise)
        grads = torch.autograd.grad(losses.sum(), list(leaves.values()), allow_unused=True)
        grads = {
            n: torch.zeros_like(p) if gr is None else gr.to(torch.float32)
            for (n, p), gr in zip(leaves.items(), grads)
        }
        losses = losses.detach()
        if self.mesh is not None:
            *reduced, losses = mean_over_ranks([*grads.values(), losses], self.mesh)
            grads = dict(zip(grads, reduced))
        return losses, grads

    def apply_updates(self, state: GridState, grads: dict) -> None:
        """clip_by_global_norm (each combo over its own leaves) ->
        scale_by_adam -> -lr_e (``encoder.*``) / -lr_d (the rest), in
        place on the stacked parameters and moments."""
        k = state.encoder_lr.shape[0]
        opt = state.opt_state
        with torch.no_grad():
            norm = torch.sqrt(sum(torch.sum((g * g).reshape(k, -1), dim=1) for g in grads.values()))
            keep = norm < self.max_norm
            opt.count += 1
            corrections = bias_corrections(opt.count)
            for name, g in grads.items():
                g = torch.where(_per_combo(keep, g), g, (g / _per_combo(norm, g)) * self.max_norm)
                update = adam_update(g, opt, name, corrections)
                lr = state.encoder_lr if name.startswith("encoder.") else state.decoder_lr
                state.params[name].add_(update * -_per_combo(lr, update))

    def grid_step(self, state: GridState, batch, temperature, seed: int = 0, noise=None):
        """One step of every combo on ``batch`` [B, G, 1, T] -> (state,
        losses [K]). The state is updated in place and returned."""
        losses, grads = self.loss_and_grads(state, batch, temperature, seed, noise)
        self.apply_updates(state, grads)
        state.step += 1
        return state, losses

    def scan_grid_step(self, state: GridState, idx_seg, temperature, seed: int, corpus):
        """[k, B, G] index segment -> k grid steps, each gathering its batch
        (with a mesh, this rank's rows) from the device ``corpus`` [N, T];
        issued back to back with no synchronisation. Returns (state, losses
        [k, K])."""
        losses = []
        for idx in idx_seg:
            state, loss = self.grid_step(state, gather_batch(corpus, shard_batch(idx, self.mesh)), temperature, seed)
            losses.append(loss)
        return state, torch.stack(losses)

    def grid_eval(self, params: dict, cpx: torch.Tensor, batch) -> torch.Tensor:
        """Every combo's eval loss on ``batch`` [B, 1, T] -> [K]; with a
        mesh, ``batch`` is this rank's rows and the losses are averaged over
        the ranks."""
        batch = torch.as_tensor(batch, device=self.device)
        evaluate = self._eval

        def combo(p, c):
            return torch.func.functional_call(evaluate, {f"model.{n}": v for n, v in p.items()}, (batch, c))

        with torch.no_grad():
            losses = torch.func.vmap(combo, randomness="error")(params, cpx)
        return losses if self.mesh is None else mean_over_ranks([losses], self.mesh)[0]

    # ------------------------------------------------------------ tune

    def tune(
        self,
        grid: dict,
        train_batches,  # epoch -> iterable of [B, G, 1, T] (or [B, G] indices with corpus)
        val_batches,  # () -> iterable of [B, 1, T] (or [B, 1] indices with val/corpus)
        epochs: int = 5,
        seed: int = 0,
        initial_temp: float = 5.0,
        min_temp: float = 0.1,
        temp_decay: float = 0.95,
        corpus=None,  # [N, T]: batches become [B, G] / [B, 1] index matrices
        val_corpus=None,
        scan_steps: int = 0,  # >1: k grid steps per segment (needs corpus)
    ) -> dict:
        """Train every combo simultaneously; returns the best combo, the
        per-combo val losses, the train curve (one [K] row a step) and the
        final grid state.

        The sampler temperature anneals per epoch with the production
        run's schedule. With ``corpus`` the waveforms are placed on the
        device once and each step gathers its [B, G] index matrix there.
        With a mesh every rank takes the same batches and keeps its rows.
        Train losses stay on the device and come to the host in one copy
        at the end. With no validation batch, ``val_losses`` stays zeros.
        """
        if corpus is not None:
            corpus = device_corpus(corpus, self.device)
            vc = corpus if val_corpus is None else device_corpus(val_corpus, self.device)

        combos = _grid_combos(grid)
        state = None
        train_curve = []
        scanned = corpus is not None and scan_steps > 1
        for epoch in range(epochs):
            temp = anneal_temperature(epoch, initial_temp, min_temp, temp_decay)
            if scanned:
                if state is None:
                    state = self.init_grid(grid, (1, 1, corpus.shape[-1]), seed)
                idx_batches = [np.asarray(b) for b in train_batches(epoch)]
                for s in range(0, len(idx_batches), scan_steps):
                    seg = torch.as_tensor(np.stack(idx_batches[s : s + scan_steps]), device=self.device)
                    state, losses = self.scan_grid_step(state, seg, temp, seed, corpus)
                    train_curve.append(losses)  # [k, K] on the device
                continue
            for batch in train_batches(epoch):
                batch = torch.as_tensor(shard_batch(np.asarray(batch), self.mesh), device=self.device)
                if corpus is not None:
                    batch = gather_batch(corpus, batch)
                if state is None:
                    state = self.init_grid(grid, (1, 1, batch.shape[-1]), seed)
                state, losses = self.grid_step(state, batch, temp, seed)
                train_curve.append(losses)  # [K] on the device
        # One copy for the whole tune; scanned [k, K] stacks become rows.
        rows = [r.reshape(-1, len(combos)) for r in train_curve]
        train_curve = list(torch.cat(rows).cpu().numpy()) if rows else []
        # Array (not scalar) accumulator: a corpus smaller than one val
        # batch yields zero batches, and argmin/tolist must still work.
        val_losses = np.zeros(len(combos))
        n_val = 0
        for batch in val_batches():
            batch = torch.as_tensor(shard_batch(np.asarray(batch), self.mesh), device=self.device)
            if corpus is not None:
                batch = vc.index_select(0, batch[:, 0])[:, None, :]
            val_losses = val_losses + self.grid_eval(
                state.params, state.complexity_penalty, batch
            ).double().cpu().numpy()
            n_val += 1
        val_losses = val_losses / max(n_val, 1)
        best = int(np.argmin(val_losses))
        return {
            "best_index": best,
            "best_params": {
                "encoder_lr": combos[best][0],
                "decoder_lr": combos[best][1],
                "complexity_penalty": combos[best][2],
            },
            "val_losses": val_losses.tolist(),
            "train_curve": [l.tolist() for l in train_curve],
            "state": state,
        }
