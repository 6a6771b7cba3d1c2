"""The train and eval steps and the optimizer.

Port of ``topo_audio_autoencoder_tpu.training.train_step``: the plain
step, the corpus-indexed step and the scanned steps.

- Two-group Adam: parameters whose name starts with ``encoder.`` train at
  the encoder's learning rate, all others at the decoder's.
- Global-norm clipping at 10 on the (accumulated) gradient, with optax's
  formula: scale by ``max_norm / norm`` only when ``norm >= max_norm``.
- Gradient accumulation over k micro-steps as ``optax.MultiSteps``: the
  running (Welford) mean of the gradients is clipped and applied on every k-th call,
  and Adam's step count advances only on applied steps.
- Contrastive batches ``[B, G, 1, T]``: every one of the B*G clips goes
  through PQMF and ``compute_logits``; InfoNCE runs on fp32 logits when
  G >= 3; only the anchors (row 0) are sampled, rectified and decoded.
- ``compute_dtype`` fp32 or bf16: fp32 master parameters, cast (with the
  batch) to the compute dtype for the forward through
  ``torch.func.functional_call``, so the gradients reach the masters
  through the cast. The rectifier and the STFT keep their fp32 islands.
- The step's randomness derives from (run seed, step counter) alone, as
  ``jax.random.fold_in(rng, step)`` does in the JAX package. Tests inject
  the sampler's uniforms (``noise``) and, for a ``hard`` model, the four
  per-rank Bernoulli uniforms (``hard_noise``).
- ``make_indexed_train_step`` keeps an [N, T] corpus on the model's device
  and gathers each step's [B, G, 1, T] batch there from a [B, G] index
  matrix, with no host round trip. ``make_scan_train_step`` and
  ``make_scan_indexed_train_step`` take K batches (or index matrices) with
  a leading axis and run K steps as a Python loop that never waits for the
  device, returning each metric stacked to [K]. The step counter advances
  through the loop, so K scanned steps equal K single ones.
- ``donate`` is accepted with the JAX package's default and has no effect
  (the step updates in place). ``mesh`` and ``shard_corpus`` belong to
  data-parallel training, which is still to come (ROADMAP.md, Queue 1
  item 6): they raise ``NotImplementedError``.

Unlike the JAX package's pure functions, the step updates the model's
parameters and the optimizer state in place and returns the same state.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.utils._pytree as pytree
from torch import nn

from ..models.autoencoder import AudioAutoencoder
from ..models.encoder import info_nce_loss, rank_diversity_entropy, vertex_count_penalty
from ..ops.samplers import temperature_schedule
from .losses import LossWeights, autoencoder_loss


@dataclass
class OptState:
    """Adam moments per parameter name, the count of applied updates, and
    the accumulation buffer (the running mean of this cycle's gradients)."""

    mu: dict
    nu: dict
    count: int = 0
    mini_step: int = 0
    acc: dict = field(default_factory=dict)


# optax.adam's defaults.
ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8


class Optimizer:
    """clip -> {encoder: adam(lr_e), decoder: adam(lr_d)}, accumulated over
    ``accumulate_grad_batches`` calls. optax's formulas, in fp32."""

    def __init__(
        self,
        encoder_lr: float = 1e-3,
        decoder_lr: float = 1e-4,
        gradient_clip_val: float = 10.0,
        accumulate_grad_batches: int = 4,
    ):
        if accumulate_grad_batches < 1:
            raise ValueError("accumulate_grad_batches must be at least 1")
        self.encoder_lr = encoder_lr
        self.decoder_lr = decoder_lr
        self.max_norm = gradient_clip_val
        self.every_k = accumulate_grad_batches

    def learning_rate(self, name: str) -> float:
        return self.encoder_lr if name.startswith("encoder.") else self.decoder_lr

    def init(self, model: nn.Module) -> OptState:
        params = dict(model.named_parameters())
        return OptState(
            mu={n: torch.zeros_like(p) for n, p in params.items()},
            nu={n: torch.zeros_like(p) for n, p in params.items()},
        )

    def update(self, grads: dict, state: OptState, model: nn.Module) -> bool:
        """Take one micro-step's gradients; on every k-th call apply the
        clipped mean gradient to ``model``'s parameters in place. Returns
        whether the parameters changed."""
        with torch.no_grad():
            if self.every_k > 1:
                n = state.mini_step
                if n == 0:
                    state.acc = {k: g.clone() for k, g in grads.items()}
                else:  # optax.MultiSteps' running mean (Welford): acc + (g - acc) / (n + 1)
                    state.acc = {
                        k: state.acc[k] + (g - state.acc[k]) / (n + 1) for k, g in grads.items()
                    }
                if n < self.every_k - 1:
                    state.mini_step = n + 1
                    return False
                grads, state.acc, state.mini_step = state.acc, {}, 0
            self._apply(self._clip(grads), state, dict(model.named_parameters()))
        return True

    def _clip(self, grads: dict) -> dict:
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        keep = norm < self.max_norm
        return {k: torch.where(keep, g, (g / norm) * self.max_norm) for k, g in grads.items()}

    def _apply(self, grads: dict, state: OptState, params: dict) -> None:
        state.count += 1
        # Bias corrections in fp32, as optax computes decay ** count.
        bc1 = float(1.0 - torch.tensor(ADAM_B1) ** state.count)
        bc2 = float(1.0 - torch.tensor(ADAM_B2) ** state.count)
        for name, g in grads.items():
            mu = (1.0 - ADAM_B1) * g + ADAM_B1 * state.mu[name]
            nu = (1.0 - ADAM_B2) * (g * g) + ADAM_B2 * state.nu[name]
            state.mu[name], state.nu[name] = mu, nu
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)
            params[name].add_(update * -self.learning_rate(name))


def make_optimizer(
    encoder_lr: float = 1e-3,
    decoder_lr: float = 1e-4,
    gradient_clip_val: float = 10.0,
    accumulate_grad_batches: int = 4,
) -> Optimizer:
    """The JAX package's ``make_optimizer`` defaults."""
    return Optimizer(encoder_lr, decoder_lr, gradient_clip_val, accumulate_grad_batches)


@dataclass
class TrainState:
    """The model (fp32 master parameters), the optimizer state and the
    micro-step counter."""

    model: AudioAutoencoder
    opt_state: OptState
    step: int = 0


def create_train_state(model: AudioAutoencoder, optimizer: Optimizer) -> TrainState:
    """A fresh optimizer state over ``model``'s current parameters."""
    return TrainState(model=model, opt_state=optimizer.init(model), step=0)


def step_generators(seed: int, step: int, device) -> tuple:
    """The step's two generators, a function of (seed, step) alone: a CPU
    generator for the sampler's seed (drawing it costs the card no
    synchronisation) and one on ``device`` for the dropout masks and the
    hard path's Bernoulli draws."""
    sample_seed, dropout_seed = np.random.SeedSequence([seed, step]).generate_state(2, np.uint64)
    sample = torch.Generator(device="cpu").manual_seed(int(sample_seed))
    dropout = torch.Generator(device=device).manual_seed(int(dropout_seed))
    return sample, dropout


def component_grad_norms(grads: dict) -> dict:
    """L2 gradient norm per top-level child: keys ``encoder/<child>`` and
    ``decoder/<child>``, as the JAX package names them."""
    groups: dict = {}
    for name, g in grads.items():
        parts = name.split(".")
        key = "/".join(parts[:2]) if len(parts) > 1 else parts[0]
        groups.setdefault(key, []).append(torch.sum(g.to(torch.float32) ** 2))
    return {k: torch.sqrt(sum(v)) for k, v in groups.items()}


class _Objective(nn.Module):
    """The loss of one contrastive batch, as a module, so that
    ``functional_call`` can run it on cast parameters."""

    def __init__(self, model: AudioAutoencoder, weights: LossWeights):
        super().__init__()
        self.model = model
        self.weights = weights

    def forward(self, batch, temperature, compute_dtype, sample_gen, dropout_gen, noise, hard_noise):
        model = self.model
        b, g, _, t = batch.shape
        flat = batch.reshape(b * g, 1, t).to(compute_dtype)
        # Encoder logits for ALL group members (contrastive needs them)...
        bands = model.pqmf(flat)
        logits = model.encoder.compute_logits(bands.transpose(-1, -2), True, dropout_gen)
        contrastive = None
        if g >= 3:
            contrastive = info_nce_loss(logits.reshape(b, g, -1).to(torch.float32))
        # ...then complex and decode for the anchors only.
        anchor_logits = logits.reshape(b, g, -1)[:, 0]
        enc = model.encoder.generate_complex(
            anchor_logits, temperature, True, sample_gen, noise, hard_noise, hard_generator=dropout_gen
        )
        anchors = flat.reshape(b, g, 1, t)[:, 0]
        recon = model.decode(enc, t // model.num_bands, True)
        aux = {
            "binary_entropy": rank_diversity_entropy(enc.rectified),
            "diversity": vertex_count_penalty(
                enc.rectified.vertices, model.min_active_vertices, model.max_active_vertices
            ),
            "l0": enc.l0,
        }
        return autoencoder_loss(
            recon.to(torch.float32),
            anchors.to(torch.float32),
            {k: v.to(torch.float32) for k, v in aux.items()},
            enc.valid,
            self.weights,
            contrastive,
        )


def make_loss_and_grads(
    model: AudioAutoencoder,
    weights: LossWeights = LossWeights(),
    compute_dtype: torch.dtype = torch.float32,
):
    """``loss_and_grads(batch, temperature, seed, step, noise=None,
    hard_noise=None) -> (total, components, grads)``: the step's forward and
    backward without the update. ``grads`` maps every parameter name to its
    fp32 gradient."""
    objective = _Objective(model, weights)

    def loss_and_grads(batch, temperature, seed: int, step: int, noise=None, hard_noise=None):
        params = dict(model.named_parameters())
        device = next(iter(params.values())).device
        batch = torch.as_tensor(batch, device=device)
        if noise is not None:
            noise = torch.as_tensor(noise, device=device)
        if hard_noise is not None:
            hard_noise = [torch.as_tensor(u, device=device) for u in hard_noise]
        sample_gen, dropout_gen = step_generators(seed, step, device)
        cast = {f"model.{n}": p.to(compute_dtype) for n, p in params.items()}
        total, components = torch.func.functional_call(
            objective, cast,
            (batch, float(temperature), compute_dtype, sample_gen, dropout_gen, noise, hard_noise),
        )
        grads = torch.autograd.grad(total, list(params.values()), allow_unused=True)
        grads = {
            n: torch.zeros_like(p) if gr is None else gr.to(torch.float32)
            for (n, p), gr in zip(params.items(), grads)
        }
        return total.detach(), {k: v.detach() for k, v in components.items()}, grads

    return loss_and_grads


def make_train_step(
    model: AudioAutoencoder,
    optimizer: Optimizer,
    weights: LossWeights = LossWeights(),
    compute_dtype: torch.dtype = torch.float32,
    with_grad_norms: bool = False,
):
    """``train_step(state, batch, temperature, seed, noise=None,
    hard_noise=None) -> (state, metrics)``. Batch: [B, G, 1, T] (G = 1
    disables the contrastive term; G >= 3 for InfoNCE). ``seed`` is the
    run's seed: the step draws from (seed, state.step). ``noise`` (uniforms
    [B, S_total]) replaces the sampler's draw and ``hard_noise`` (four
    per-rank uniform tensors [B, S_r]) a hard model's Bernoulli draws.
    Metrics are 0-d tensors on the model's device (no synchronisation),
    with ``grad_norms`` when asked."""
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, not {compute_dtype}")
    loss_and_grads = make_loss_and_grads(model, weights, compute_dtype)

    def train_step(state: TrainState, batch, temperature, seed: int, noise=None, hard_noise=None):
        if state.model is not model:
            raise ValueError("the state's model is not the one this step was made for")
        _, components, grads = loss_and_grads(batch, temperature, seed, state.step, noise, hard_noise)
        optimizer.update(grads, state.opt_state, model)
        metrics = dict(components)
        if with_grad_norms:
            metrics["grad_norms"] = component_grad_norms(grads)
        state.step += 1
        return state, metrics

    return train_step


def make_eval_step(model: AudioAutoencoder, weights: LossWeights = LossWeights()):
    """``eval_step(batch) -> (total, components)``: the deterministic eval
    forward and loss of the model's current parameters. Batch: [B, 1, T]."""

    def eval_step(batch):
        device = next(model.parameters()).device
        batch = torch.as_tensor(batch, device=device)
        with torch.no_grad():
            out = model(batch, 1.0, train=False)
            return autoencoder_loss(
                out.waveform, batch, out.aux, out.valid, weights, with_per_sample=True
            )

    return eval_step


def anneal_temperature(epoch, initial_temp: float = 5.0, min_temp: float = 0.1, decay: float = 0.95):
    """Per-epoch sampler temperature, max(min_temp, T0 * decay^epoch)."""
    return temperature_schedule(epoch, initial_temp, min_temp, decay)


def _no_data_parallel(mesh, shard_corpus: bool) -> None:
    if mesh is not None or shard_corpus:
        raise NotImplementedError(
            "mesh and shard_corpus belong to data-parallel training, which the port does not "
            "have yet (ROADMAP.md, Queue 1 item 6: DistributedDataParallel)"
        )


def gather_batch(corpus: torch.Tensor, idxs) -> torch.Tensor:
    """``corpus[idxs][:, :, None, :]``: the [B, G, 1, T] batch of the [B, G]
    index matrix ``idxs`` (int32 or int64), gathered on the corpus's device."""
    idx = torch.as_tensor(idxs, device=corpus.device)
    return corpus.index_select(0, idx.reshape(-1)).reshape(*idx.shape, 1, corpus.shape[-1])


def device_corpus(corpus, device) -> torch.Tensor:
    """An [N, T] corpus as float32 on ``device``; a tensor already there is
    used as it is (no copy)."""
    if isinstance(corpus, torch.Tensor):
        return corpus.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.ascontiguousarray(corpus, dtype=np.float32)).to(device)


def make_indexed_train_step(
    model: AudioAutoencoder,
    optimizer: Optimizer,
    corpus,
    weights: LossWeights = LossWeights(),
    compute_dtype: torch.dtype = torch.float32,
    with_grad_norms: bool = False,
    donate: bool = True,
    mesh=None,
    shard_corpus: bool = False,
):
    """``indexed_step(state, idxs, temperature, seed) -> (state, metrics)``:
    the train step over a corpus (``[N, T]`` numpy array or tensor) placed
    on the model's device once. Each call takes a [B, G] index matrix and
    gathers its batch there; the sampling is ``NSynthDataset``'s."""
    _no_data_parallel(mesh, shard_corpus)
    base = make_train_step(model, optimizer, weights, compute_dtype, with_grad_norms)
    corpus_dev = device_corpus(corpus, next(model.parameters()).device)

    def indexed_step(state: TrainState, idxs, temperature, seed: int):
        return base(state, gather_batch(corpus_dev, idxs), temperature, seed)

    return indexed_step


def make_scan_train_step(train_step, donate: bool = True):
    """``scan_steps(state, batches, temperature, seed) -> (state, metrics)``:
    K train steps of ``train_step`` over batches with a leading [K] axis,
    issued back to back with no synchronisation; every metric comes back
    stacked to [K]. The step's randomness derives from (seed, state.step),
    so the result equals K single steps."""

    def scan_steps(state: TrainState, batches, temperature, seed: int):
        per_step = []
        for batch in batches:
            state, metrics = train_step(state, batch, temperature, seed)
            per_step.append(metrics)
        return state, pytree.tree_map(lambda *leaves: torch.stack(leaves), *per_step)

    return scan_steps


def make_scan_indexed_train_step(
    model: AudioAutoencoder,
    optimizer: Optimizer,
    corpus,
    weights: LossWeights = LossWeights(),
    compute_dtype: torch.dtype = torch.float32,
    with_grad_norms: bool = False,
    donate: bool = True,
    mesh=None,
    shard_corpus: bool = False,
):
    """The scanned variant of ``make_indexed_train_step``: takes [K, B, G]
    index matrices and runs K steps, each gathering its batch from the
    device corpus."""
    return make_scan_train_step(
        make_indexed_train_step(
            model, optimizer, corpus, weights, compute_dtype, with_grad_norms, mesh=mesh,
            shard_corpus=shard_corpus,
        )
    )
