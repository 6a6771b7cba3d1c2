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
  (the step updates in place).
- Data parallelism (``mesh=``, a ``parallel.DataMesh``): each rank runs
  the step on its rows of the global batch, with each random draw made at
  the global shape and cut to its rows. After the backward the gradients
  are flattened in parameter order into one fp32 buffer and averaged over
  the ranks by one all-reduce (sum, then / D), before the optimizer, on
  every micro-step (so the accumulated mean is over averaged gradients, as
  ``optax.MultiSteps`` sees them); the metrics are averaged by one more.
  The ranks' means over equal shards are the global batch's means, so the
  D-rank step computes the 1-rank step. ``DistributedDataParallel`` does
  not fit: it needs ``.backward()`` on a wrapped module, and the step runs
  ``functional_call`` on cast parameters with ``autograd.grad``.
- The indexed steps take the global [B, G] index matrix on every rank.
  With a mesh the corpus is either on every rank (each gathers its rows)
  or split by rows over the ranks (``shard_corpus``,
  ``make_sharded_corpus_gather``).

Unlike the JAX package's pure functions, the step updates the model's
parameters and the optimizer state in place and returns the same state.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist
import torch.utils._pytree as pytree
from torch import nn

from ..models.autoencoder import AudioAutoencoder
from ..models.encoder import info_nce_loss, rank_diversity_entropy, vertex_count_penalty
from ..ops.samplers import temperature_schedule
from ..parallel import mean_over_ranks, row_shard, shard_batch
from .losses import LossWeights, autoencoder_loss


@dataclass
class OptState:
    """Adam moments per parameter name (with ``flat_groups``: one flat
    vector per group, keyed ``encoder`` and ``decoder``), the count of
    applied updates, and the accumulation buffer (the running mean of this
    cycle's gradients, per parameter name in either layout)."""

    mu: dict
    nu: dict
    count: int = 0
    mini_step: int = 0
    acc: dict = field(default_factory=dict)


# optax.adam's defaults.
ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8
GROUPS = ("encoder", "decoder")


def group_of(name: str) -> str:
    """The optimizer group of a parameter name."""
    return "encoder" if name.startswith("encoder.") else "decoder"


def flax_order(params: dict) -> list:
    """The parameter names in the order of the JAX package's leaves: flax
    paths sorted component by component, a ``weight`` named by its flax
    leaf (``scale`` for a norm's 1-d weight, else ``kernel``). It is the
    order in which ``optax.flatten`` ravels a group's leaves."""

    def path(name):
        *modules, leaf = name.split(".")
        if leaf == "weight":
            leaf = "scale" if params[name].ndim == 1 else "kernel"
        return (*modules, leaf)

    return sorted(params, key=path)


class Optimizer:
    """clip -> {encoder: adam(lr_e), decoder: adam(lr_d)}, accumulated over
    ``accumulate_grad_batches`` calls. optax's formulas, in fp32.

    ``flat_groups``: each group's Adam runs on one flat vector, as the JAX
    package's ``optax.flatten`` does: the group's clipped gradients are
    concatenated in ``flax_order``, the moments are one vector a group, and
    the update reaches the parameters through views of one flat update.
    The elementwise arithmetic is the per-leaf path's, so both layouts give
    the same bits. The clip and the accumulation stay per leaf, as optax
    applies them outside the flatten."""

    def __init__(
        self,
        encoder_lr: float = 1e-3,
        decoder_lr: float = 1e-4,
        gradient_clip_val: float = 10.0,
        accumulate_grad_batches: int = 4,
        flat_groups: bool = False,
    ):
        if accumulate_grad_batches < 1:
            raise ValueError("accumulate_grad_batches must be at least 1")
        self.encoder_lr = encoder_lr
        self.decoder_lr = decoder_lr
        self.max_norm = gradient_clip_val
        self.every_k = accumulate_grad_batches
        self.flat_groups = flat_groups
        self._groups = (None, None)

    def learning_rate(self, name: str) -> float:
        return self.group_learning_rate(group_of(name))

    def group_learning_rate(self, group: str) -> float:
        return self.encoder_lr if group == "encoder" else self.decoder_lr

    def groups(self, params: dict) -> dict:
        """Each group's parameter names in ``flax_order`` (kept for the
        names last asked about)."""
        names = tuple(params)
        if self._groups[0] != names:
            order = flax_order(params)
            self._groups = (names, {g: [n for n in order if group_of(n) == g] for g in GROUPS})
        return self._groups[1]

    def init(self, model: nn.Module) -> OptState:
        params = dict(model.named_parameters())
        if self.flat_groups:
            groups = self.groups(params)
            zeros = {g: torch.cat([torch.zeros_like(params[n]).reshape(-1) for n in names])
                     for g, names in groups.items()}
            return OptState(mu=zeros, nu={g: z.clone() for g, z in zeros.items()})
        return OptState(
            mu={n: torch.zeros_like(p) for n, p in params.items()},
            nu={n: torch.zeros_like(p) for n, p in params.items()},
        )

    def check_layout(self, moments: dict, params: dict, what: str = "the optimizer state") -> None:
        """Raises unless ``moments`` (a state's ``mu`` or ``nu``) is in this
        optimizer's layout: one tensor per parameter name, or with
        ``flat_groups`` one vector per group."""
        flat = set(moments) == set(GROUPS)
        if flat != self.flat_groups:
            raise ValueError(
                f"{what} holds {'flat per-group' if flat else 'per-leaf'} Adam moments, and this optimizer "
                f"has flat_groups={self.flat_groups}: a state restores only into the layout it was saved from"
            )
        if not flat and set(moments) != set(params):
            raise KeyError(f"{what}: the moments do not cover the model's parameters")
        for group, names in self.groups(params).items() if flat else ():
            size = sum(params[n].numel() for n in names)
            if moments[group].numel() != size:
                raise ValueError(f"{what}: the {group} group's flat moments hold {moments[group].numel()} "
                                 f"elements, its parameters {size}")

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
        corrections = bias_corrections(state.count)
        if self.flat_groups:
            for group, names in self.groups(params).items():
                flat = torch.cat([grads[n].reshape(-1) for n in names])
                update = adam_update(flat, state, group, corrections) * -self.group_learning_rate(group)
                views = update.split([params[n].numel() for n in names])
                torch._foreach_add_([params[n] for n in names], [v.view_as(params[n]) for v, n in zip(views, names)])
            return
        for name, g in grads.items():
            update = adam_update(g, state, name, corrections)
            params[name].add_(update * -self.learning_rate(name))


def bias_corrections(count: int) -> tuple[float, float]:
    """Adam's bias corrections 1 - decay ** count, in fp32 as optax computes
    them."""
    return float(1.0 - torch.tensor(ADAM_B1) ** count), float(1.0 - torch.tensor(ADAM_B2) ** count)


def adam_update(g: torch.Tensor, state: OptState, name: str, corrections: tuple) -> torch.Tensor:
    """optax.scale_by_adam on one leaf (or one group's flat vector): updates
    the moments ``state.mu[name]`` and ``state.nu[name]`` with the gradient
    ``g`` and returns the normalized update (before the learning rate)."""
    bc1, bc2 = corrections
    mu = (1.0 - ADAM_B1) * g + ADAM_B1 * state.mu[name]
    nu = (1.0 - ADAM_B2) * (g * g) + ADAM_B2 * state.nu[name]
    state.mu[name], state.nu[name] = mu, nu
    return (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)


def make_optimizer(
    encoder_lr: float = 1e-3,
    decoder_lr: float = 1e-4,
    gradient_clip_val: float = 10.0,
    accumulate_grad_batches: int = 4,
    flat_groups: bool = False,
) -> Optimizer:
    """The JAX package's ``make_optimizer`` defaults; ``flat_groups`` as
    there (``Optimizer``), off by default."""
    return Optimizer(encoder_lr, decoder_lr, gradient_clip_val, accumulate_grad_batches, flat_groups)


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

    def forward(self, batch, temperature, compute_dtype, sample_gen, dropout_gen, noise, hard_noise, shard):
        model = self.model
        b, g, _, t = batch.shape
        flat = batch.reshape(b * g, 1, t).to(compute_dtype)
        # Encoder logits for ALL group members (contrastive needs them)...
        bands = model.pqmf(flat)
        logits = model.encoder.compute_logits(bands.transpose(-1, -2), True, dropout_gen, shard=shard)
        contrastive = None
        if g >= 3:
            contrastive = info_nce_loss(logits.reshape(b, g, -1).to(torch.float32))
        # ...then complex and decode for the anchors only.
        anchor_logits = logits.reshape(b, g, -1)[:, 0]
        enc = model.encoder.generate_complex(
            anchor_logits, temperature, True, sample_gen, noise, hard_noise, hard_generator=dropout_gen,
            shard=shard,
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
    mesh=None,
):
    """``loss_and_grads(batch, temperature, seed, step, noise=None,
    hard_noise=None) -> (total, components, grads)``: the step's forward and
    backward without the update. ``grads`` maps every parameter name to its
    fp32 gradient. With ``mesh``, ``batch`` (and ``noise``, ``hard_noise``)
    are this rank's rows of the global batch, and the loss, components and
    gradients come back averaged over the ranks: the global batch's."""
    objective = _Objective(model, weights)
    shard = row_shard(mesh)

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
            (batch, float(temperature), compute_dtype, sample_gen, dropout_gen, noise, hard_noise, shard),
        )
        grads = torch.autograd.grad(total, list(params.values()), allow_unused=True)
        grads = {
            n: torch.zeros_like(p) if gr is None else gr.to(torch.float32)
            for (n, p), gr in zip(params.items(), grads)
        }
        components = {k: v.detach() for k, v in components.items()}
        if mesh is not None:
            grads = dict(zip(grads, mean_over_ranks(list(grads.values()), mesh)))
            components = dict(zip(components, mean_over_ranks(list(components.values()), mesh)))
            total = components["total_loss"]
        return total.detach(), components, grads

    return loss_and_grads


def make_train_step(
    model: AudioAutoencoder,
    optimizer: Optimizer,
    weights: LossWeights = LossWeights(),
    compute_dtype: torch.dtype = torch.float32,
    with_grad_norms: bool = False,
    mesh=None,
):
    """``train_step(state, batch, temperature, seed, noise=None,
    hard_noise=None) -> (state, metrics)``. Batch: [B, G, 1, T] (G = 1
    disables the contrastive term; G >= 3 for InfoNCE). ``seed`` is the
    run's seed: the step draws from (seed, state.step). ``noise`` (uniforms
    [B, S_total]) replaces the sampler's draw and ``hard_noise`` (four
    per-rank uniform tensors [B, S_r]) a hard model's Bernoulli draws.
    Metrics are 0-d tensors on the model's device (no synchronisation),
    with ``grad_norms`` when asked. With ``mesh`` the batch and the noise
    are this rank's rows (``parallel.shard_batch``), and the update and the
    metrics are the global batch's on every rank."""
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, not {compute_dtype}")
    loss_and_grads = make_loss_and_grads(model, weights, compute_dtype, mesh)

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


def make_sharded_corpus_gather(mesh, corpus):
    """The train corpus split by rows over the ranks, and a gather that
    builds each rank's batch from the split rows.

    Port of the JAX package's ``make_sharded_corpus_gather``: the corpus is
    padded with zero rows to a multiple of D on the host, and each rank
    places only its ceil(N / D) rows on its device, so D ranks hold a corpus
    D times one card's memory. Each step, every rank takes the global
    [B, G] index matrix, gathers the rows it owns (zeros for the others'),
    and one ``reduce_scatter_tensor`` over the batch axis sums the ranks'
    contributions (one rank owns each row, so the sum is exact) and leaves
    each rank its [B/D, G] block: the rows the replicated corpus would
    gather.

    Returns ``(corpus_dev, gather)``, with ``gather(corpus_dev, idxs) ->
    [B/D, G, 1, T]`` this rank's rows of the batch.
    """
    d, rank = mesh.size, mesh.rank
    host = corpus.detach().cpu().numpy() if isinstance(corpus, torch.Tensor) else np.asarray(corpus)
    n, t = host.shape
    n_local = -(-n // d)
    rows = host[rank * n_local : (rank + 1) * n_local].astype(np.float32)
    local = np.zeros((n_local, t), np.float32)
    local[: rows.shape[0]] = rows
    corpus_dev = torch.from_numpy(local).to(mesh.device)

    def gather(shard, idxs):
        idx = torch.as_tensor(idxs, device=shard.device).to(torch.int64)
        b, g = idx.shape
        if b % d:
            raise ValueError(f"a batch of {b} rows does not split over {d} ranks")
        pos = idx - rank * n_local
        owned = (pos >= 0) & (pos < n_local)
        got = shard.index_select(0, pos.clamp(0, n_local - 1).reshape(-1)).reshape(b, g, t)
        got = torch.where(owned[..., None], got, torch.zeros((), dtype=got.dtype, device=got.device))
        out = torch.empty((b // d, g, t), dtype=got.dtype, device=got.device)
        dist.reduce_scatter_tensor(out, got, group=mesh.group)
        return out[:, :, None, :]

    return corpus_dev, gather


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
    gathers its batch there; the sampling is ``NSynthDataset``'s.

    With ``mesh`` every rank takes the global index matrix and steps on its
    rows: by default the corpus is on every rank and each gathers its rows
    locally; ``shard_corpus=True`` splits the corpus by rows over the ranks
    (``make_sharded_corpus_gather``), for corpora larger than one card.
    ``shard_corpus`` without a mesh is ignored, as in the JAX package."""
    base = make_train_step(model, optimizer, weights, compute_dtype, with_grad_norms, mesh)
    if mesh is not None and shard_corpus:
        corpus_dev, gather = make_sharded_corpus_gather(mesh, corpus)
    else:
        corpus_dev = device_corpus(corpus, next(model.parameters()).device)

        def gather(corpus, idxs):
            return gather_batch(corpus, shard_batch(idxs, mesh))

    def indexed_step(state: TrainState, idxs, temperature, seed: int):
        return base(state, gather(corpus_dev, idxs), temperature, seed)

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
    device corpus (with ``mesh``, each rank its rows of each step's
    batch)."""
    return make_scan_train_step(
        make_indexed_train_step(
            model, optimizer, corpus, weights, compute_dtype, with_grad_norms, mesh=mesh,
            shard_corpus=shard_corpus,
        )
    )
