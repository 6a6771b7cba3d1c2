"""Trainer shell: epoch loop, validation, early stopping, checkpoints,
grid-search tuner with resume, audio dumps.

Port of ``topo_audio_autoencoder_tpu.training.trainer``, with its control
flow, cadences, file layout and keys:

- epoch loop up to ``max_epochs``, early-stop ``patience``, checkpoint
  'best' on val improvement, 'latest' every epoch, ``epoch_N`` every
  ``checkpoint_every_epochs`` epochs and ``epoch_E_iter_I`` every
  ``checkpoint_every_iters`` iterations;
- grid-search tuner over encoder_lr x decoder_lr x complexity_penalty,
  ``tuning_epochs`` per combo, per-combo checkpoint dirs with
  resume-from-latest;
- per-epoch sampler temperature annealing; curriculum ``set_epoch`` on the
  train dataset;
- every ``log_every`` steps: loss components + per-component gradient norms
  to ``train_log.jsonl`` and input/output wav dumps with
  active-simplex-count metadata;
- checkpoints of params/optimizer state/step + a JSON sidecar.

What differs, and why:

- The steps update the model's parameters and the optimizer state in
  place (the JAX package donates them). So every restore copies into the
  live model (``load_state_dict``) and the live ``OptState``; none builds
  a new model, since the step closures hold this one.
- The host's random state is a two-word key in the layout of a JAX PRNG
  key, ``[hi, lo]`` of the seed, split by ``split_key``. ``init_state`` splits it every
  time it runs: one half re-seeds the model's weights
  (``reset_parameters``), so every tuner combo starts from fresh weights,
  and the other becomes the key whose 64-bit value (``run_seed``) is the
  seed of every step (each step draws from (seed, step)). The sidecar
  stores it as ``train_state.rng_key``, and a resumed run draws the same
  noise as the uninterrupted one.
- Nothing in an epoch waits for the device but the ``log_every`` writes
  and the cadence checkpoints: each step's loss stays a 0-d device tensor,
  and the epoch's losses come to the host in one copy at its end.
- An asynchronous save first clones every parameter and moment on the
  device (the next step overwrites the live ones), then a thread copies
  the clones to the host on a side stream that waits for them, and writes.
- Data-parallel training (``data_parallel``) runs one process a device
  (``torchrun --nproc_per_node=N``) on the data mesh of ``parallel``:
  every rank runs the same NumPy sampling with the same seed and steps on
  its rows of each batch; the steps average the gradients and metrics over
  the ranks, so every rank holds the same state and takes the same
  decisions. The state is broadcast from rank 0 after ``init_state`` and
  after every restore. ``validate`` evaluates each rank's rows and gathers
  the per-clip losses of every batch, summed then as one process sums
  them. Only rank 0 writes checkpoints, ``metrics.json``,
  ``train_log.jsonl`` and audio dumps, and every write is followed by a
  barrier, so that every rank can read back what was written.
  ``shard_corpus`` splits the train corpus by rows over the ranks
  (``make_sharded_corpus_gather``). The vmapped grid tuner
  (``tune_hyperparameters_vmapped``, ``training/tuner.py``) runs on the
  same mesh.

No interactive prompts: everything is constructor config. The trainer runs
on ``config.device``: the CUDA card unless it says ``"cpu"``.
"""

from __future__ import annotations

import itertools
import json
import threading
import weakref
from dataclasses import asdict, dataclass
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.utils._pytree as pytree

from ..data.dataset import NSynthDataset, batch_iterator, index_iterator, prefetch_to_device
from ..data.preprocess import save_wav
from ..device import resolve_device
from ..models.autoencoder import AudioAutoencoder
from ..parallel import gather_rows, make_mesh, pad_to_multiple, replicate, shard_batch
from .checkpoint import CheckpointManager, to_host
from .losses import LossWeights
from .metrics import MetricWriter, TrainingMetrics
from .train_step import (
    TrainState,
    anneal_temperature,
    create_train_state,
    device_corpus,
    make_eval_step,
    make_indexed_train_step,
    make_optimizer,
    make_scan_indexed_train_step,
    make_train_step,
)

def split_key(key) -> tuple[list, int]:
    """(new key, 64-bit seed): a pure function of the key ``[hi, lo]``."""
    words = np.random.SeedSequence([int(w) for w in key]).generate_state(4, np.uint32)
    return [int(words[0]), int(words[1])], int(words[2]) << 32 | int(words[3])


def _drain(trees: list) -> list:
    """Nested dicts of [K] device tensors -> the same dicts of numpy
    arrays, in one device-to-host copy."""
    leaves, spec = pytree.tree_flatten(trees)
    flat = torch.cat([leaf.to(torch.float32) for leaf in leaves]).cpu()
    return pytree.tree_unflatten([x.numpy() for x in flat.split([leaf.numel() for leaf in leaves])], spec)


@dataclass
class TrainerConfig:
    """The JAX package's ``TrainerConfig``, field for field, plus
    ``device``."""

    checkpoint_dir: str = "./checkpoints"
    encoder_lr: float = 1e-3
    decoder_lr: float = 1e-4
    batch_size: int = 4
    initial_reg_factor: float = 1e-5  # binary_entropy_penalty
    complexity_penalty: float = 0.1
    l0_penalty: float = 0.0  # Hard Concrete expected-L0 sparsity weight
    invalid_state_penalty: float = 100.0
    seed: int = 511990
    initial_temp: float = 5.0
    min_temp: float = 0.1
    temp_decay: float = 0.95
    gradient_clip_val: float = 10.0
    accumulate_grad_batches: int = 4
    max_epochs: int = 100
    patience: int = 20
    tuning_epochs: int = 5
    log_every: int = 10
    checkpoint_every_iters: int = 100
    checkpoint_every_epochs: int = 10
    sample_rate: int = 16000
    compute_dtype: str = "float32"  # or "bfloat16"
    with_grad_norms: bool = True
    dump_audio: bool = True
    # Keep the training corpus on the device and send only [B, G] index
    # matrices per step; the step gathers the rows there.
    device_corpus: bool = True
    # Data-parallel training, one process a device (torchrun
    # --nproc_per_node=N): state replicated, batches split by rows,
    # gradients averaged by an all-reduce. batch_size must divide over the
    # ranks; n_devices, when set, must equal their number.
    data_parallel: bool = False
    n_devices: int | None = None
    # Split the TRAIN corpus rows over the ranks instead of placing all of
    # it on every device: D times the capacity, at one reduce-scatter of
    # the batch a step (make_sharded_corpus_gather). Requires
    # data_parallel and device_corpus; the val corpus stays whole.
    shard_corpus: bool = False
    # Run the epoch in segments of this many steps (device_corpus only;
    # 0/1 = one step at a time), each segment's index matrices sent at
    # once and its metrics stacked.
    scan_steps: int = 0
    # End-of-epoch checkpoints on a background thread, from a device-side
    # clone of the state.
    async_checkpoint: bool = True
    # Save the optimizer's moments in bfloat16 (cast on the device before
    # the copy); restored to their live dtypes. Params are never cast.
    checkpoint_moments_bf16: bool = False
    # Where the trainer runs: None = the CUDA card, "cpu" = the plain path.
    device: str | None = None


class Trainer:
    def __init__(
        self,
        model: AudioAutoencoder,
        train_dataset: NSynthDataset,
        val_dataset: NSynthDataset,
        test_dataset: NSynthDataset | None = None,
        config: TrainerConfig = TrainerConfig(),
    ):
        self.mesh = None
        if config.data_parallel:
            self.mesh = make_mesh(config.n_devices, device=config.device)
            if config.batch_size % self.mesh.size != 0:
                raise ValueError(
                    f"batch_size {config.batch_size} must divide the {self.mesh.size}-device mesh"
                )
        if config.shard_corpus and (self.mesh is None or not config.device_corpus):
            raise ValueError("shard_corpus requires data_parallel and device_corpus")
        self.device = self.mesh.device if self.mesh is not None else resolve_device(config.device)
        self.model = model.to(self.device)
        self.train_dataset = train_dataset
        self.val_dataset = val_dataset
        self.test_dataset = test_dataset
        self.cfg = config
        self.checkpoint_dir = Path(config.checkpoint_dir)
        self.checkpoint_dir.mkdir(parents=True, exist_ok=True)
        self.metrics = TrainingMetrics()
        self.writer = MetricWriter(self.checkpoint_dir)
        self.rng = [(config.seed >> 32) & 0xFFFFFFFF, config.seed & 0xFFFFFFFF]  # as jax.random.PRNGKey
        self._corpus_dev = None  # the train corpus on the device, placed once
        self._val_corpus_ref = None  # weak reference to the dataset of _val_corpus_dev
        self._val_corpus_dev = None
        self._ckpt_thread = None  # at most one async save in flight
        self._ckpt_error = None
        self._ckpt_stream = None
        self._build(config.encoder_lr, config.decoder_lr, config.complexity_penalty)
        self.state: TrainState | None = None

    # ------------------------------------------------------------ setup

    @property
    def writes(self) -> bool:
        """Whether this process writes the run's files: rank 0 of the mesh,
        or the only process."""
        return self.mesh is None or self.mesh.rank == 0

    def _barrier(self) -> None:
        """Under data parallelism, waits for every rank (after rank 0's
        writes, so that all can read them)."""
        if self.mesh is not None:
            dist.barrier(group=self.mesh.group)

    @property
    def run_seed(self) -> int:
        """The seed every step draws from, with its step counter: the host
        key's two words as one 64-bit integer."""
        return int(self.rng[0]) << 32 | int(self.rng[1])

    def _train_corpus(self) -> torch.Tensor:
        if self._corpus_dev is None:
            self._corpus_dev = device_corpus(np.asarray(self.train_dataset.waveforms), self.device)
        return self._corpus_dev

    def _build(self, encoder_lr, decoder_lr, complexity_penalty):
        """(Re)build optimizer + steps for a hyperparam combo."""
        cfg = self.cfg
        self.hyper = {
            "encoder_lr": encoder_lr,
            "decoder_lr": decoder_lr,
            "complexity_penalty": complexity_penalty,
        }
        self.optimizer = make_optimizer(
            encoder_lr=encoder_lr,
            decoder_lr=decoder_lr,
            gradient_clip_val=cfg.gradient_clip_val,
            accumulate_grad_batches=cfg.accumulate_grad_batches,
        )
        weights = LossWeights(
            binary_entropy_penalty=cfg.initial_reg_factor,
            complexity_penalty=complexity_penalty,
            invalid_state_penalty=cfg.invalid_state_penalty,
            l0_penalty=cfg.l0_penalty,
        )
        dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
        dp = dict(mesh=self.mesh, shard_corpus=cfg.shard_corpus)
        self.scan_train_step = None
        if cfg.device_corpus and cfg.scan_steps > 1:
            self.scan_train_step = make_scan_indexed_train_step(
                self.model, self.optimizer, self._step_corpus(), weights,
                compute_dtype=dtype, with_grad_norms=cfg.with_grad_norms, **dp,
            )
        if cfg.device_corpus:
            self.train_step = make_indexed_train_step(
                self.model, self.optimizer, self._step_corpus(), weights,
                compute_dtype=dtype, with_grad_norms=cfg.with_grad_norms, **dp,
            )
        else:
            self.train_step = make_train_step(
                self.model, self.optimizer, weights,
                compute_dtype=dtype, with_grad_norms=cfg.with_grad_norms, mesh=self.mesh,
            )
        self.eval_step = make_eval_step(self.model, weights)

    def _step_corpus(self):
        """The corpus the indexed steps take: the host array when it is
        split over the ranks (never placed whole), else the device copy."""
        if self.cfg.shard_corpus:
            return np.asarray(self.train_dataset.waveforms)
        return self._train_corpus()

    def init_state(self) -> TrainState:
        """Fresh weights and optimizer state. Splits the host key: one half
        seeds the weights, the other becomes the run's key. Under data
        parallelism the state is broadcast from rank 0."""
        self.rng, init_seed = split_key(self.rng)
        self.model.reset_parameters(init_seed)
        state = create_train_state(self.model, self.optimizer)
        return state if self.mesh is None else replicate(state, self.mesh)

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        """A host array on the trainer's device; to the card through pinned
        memory and a copy that does not wait for the device."""
        host = torch.from_numpy(np.ascontiguousarray(array))
        if self.device.type != "cuda":
            return host
        return host.pin_memory().to(self.device, non_blocking=True)

    def _state_tree(self, clone: bool = False, cast_moments: bool = False) -> dict:
        """The state as the checkpoint holds it (on the device): params and
        moments by parameter name, the counters as Python ints. ``clone``
        copies every tensor; ``cast_moments`` casts every float tensor of
        the optimizer state to bfloat16, as the JAX package does."""
        st = self.state
        keep = (lambda t: t.detach().clone()) if clone else (lambda t: t.detach())
        moment = (lambda t: t.detach().to(torch.bfloat16)) if cast_moments else keep
        opt = st.opt_state
        return {
            "params": {n: keep(p) for n, p in st.model.named_parameters()},
            "opt_state": {
                "mu": {n: moment(t) for n, t in opt.mu.items()},
                "nu": {n: moment(t) for n, t in opt.nu.items()},
                "count": int(opt.count),
                "mini_step": int(opt.mini_step),
                "acc": {n: moment(t) for n, t in opt.acc.items()},
            },
            "step": int(st.step),
        }

    def _load_tree(self, tree: dict) -> None:
        """Copy a checkpoint's state into the live model and the live
        ``OptState``; moments take the live state's dtype and device (so
        bfloat16 moments come back in the live dtype). A state saved in the
        other optimizer layout (``flat_groups``) raises."""
        st = self.state
        params = dict(st.model.named_parameters())
        opt = tree["opt_state"]
        live_opt = st.opt_state
        for what in ("mu", "nu"):
            self.optimizer.check_layout(opt[what], params, f"checkpoint {what}")
        with torch.no_grad():
            st.model.load_state_dict(tree["params"])

        def live(moments, like):
            return {n: t.to(device=like[n].device, dtype=like[n].dtype) for n, t in moments.items()}

        live_opt.mu, live_opt.nu = live(opt["mu"], live_opt.mu), live(opt["nu"], live_opt.nu)
        live_opt.acc = live(opt["acc"], params)
        live_opt.count, live_opt.mini_step = int(opt["count"]), int(opt["mini_step"])
        st.step = int(tree["step"])
        if self.mesh is not None:
            replicate(st, self.mesh)

    # ------------------------------------------------------------ loops

    def train_epoch(self, epoch: int, sample_dir: Path | None = None) -> float:
        """One epoch: batches are prefetched to the device, each step's
        randomness derives from (run seed, step counter), and the per-step
        losses stay on the device until one copy at the epoch's end. The
        only mid-epoch synchronisations are the log_every metric writes
        and the cadence checkpoints. Under data parallelism an array batch
        is cut to this rank's rows here, an index batch in the step."""
        cfg = self.cfg
        temp = anneal_temperature(epoch, cfg.initial_temp, cfg.min_temp, cfg.temp_decay)
        if self.scan_train_step is not None:
            return self._train_epoch_scanned(epoch, temp, sample_dir)
        make_iter = index_iterator if cfg.device_corpus else batch_iterator
        it = make_iter(
            self.train_dataset, cfg.batch_size, shuffle=True,
            seed=cfg.seed, epoch=epoch,
        )
        if not cfg.device_corpus:
            it = (shard_batch(b, self.mesh) for b in it)
        it = prefetch_to_device(it, size=2, device=self.device)
        loss_refs: list = []
        for iteration, batch in enumerate(it):
            self.state, metrics = self.train_step(self.state, batch, temp, self.run_seed)
            loss_refs.append(metrics["total_loss"])
            if iteration % cfg.log_every == 0 and self.writes:
                self.writer.write(self.state.step, metrics)
                if cfg.dump_audio and sample_dir is None:
                    self._dump_audio(epoch, iteration, batch)
            if (
                cfg.checkpoint_every_iters
                and iteration > 0
                and iteration % cfg.checkpoint_every_iters == 0
            ):
                # iteration > 0: the per-epoch 'latest' save already covers
                # epoch starts.
                self.save_checkpoint(f"epoch_{epoch}_iter_{iteration}", sample_dir)
        losses = torch.stack(loss_refs).cpu().tolist() if loss_refs else []
        self.metrics.iteration_losses.extend(losses)
        return sum(losses) / max(len(losses), 1)

    def _train_epoch_scanned(self, epoch: int, temp, sample_dir) -> float:
        """The epoch as segments of ``scan_steps`` steps: the epoch's index
        matrices go to the device in one copy, each segment runs as one
        scanned call, and the stacked metrics come back in one copy at the
        end, from which the log_every records are written (the same stream
        as the per-step loop, written later). Segment boundaries carry the
        iteration-cadence checkpoints. The trajectory is the per-step
        loop's."""
        cfg = self.cfg
        idx_batches = list(
            index_iterator(
                self.train_dataset, cfg.batch_size, shuffle=True,
                seed=cfg.seed, epoch=epoch,
            )
        )
        if not idx_batches:
            return 0.0
        if cfg.dump_audio and sample_dir is None and self.writes:
            self._dump_audio(epoch, 0, idx_batches[0])
        k = cfg.scan_steps
        all_idx = self._to_device(np.stack(idx_batches))  # [steps, B, G]
        seg_refs = []
        for s in range(0, len(idx_batches), k):
            seg = all_idx[s : s + k]
            self.state, metrics = self.scan_train_step(self.state, seg, temp, self.run_seed)
            seg_refs.append(metrics)
            end = s + seg.shape[0]
            if (
                cfg.checkpoint_every_iters
                and end < len(idx_batches)
                and end // cfg.checkpoint_every_iters
                > s // cfg.checkpoint_every_iters
            ):
                self.save_checkpoint(f"epoch_{epoch}_iter_{end}", sample_dir)
        host = _drain(seg_refs)  # one device-to-host copy for the epoch
        step_after = int(self.state.step)
        losses: list[float] = []
        it = 0
        total = sum(len(m["total_loss"]) for m in host)
        for seg_m in host:
            for j in range(len(seg_m["total_loss"])):
                if it % cfg.log_every == 0 and self.writes:
                    self.writer.write(step_after - total + it + 1, pytree.tree_map(lambda v: v[j], seg_m))
                losses.append(float(seg_m["total_loss"][j]))
                it += 1
        self.metrics.iteration_losses.extend(losses)
        return sum(losses) / max(len(losses), 1)

    def validate(self, dataset: NSynthDataset | None = None) -> float:
        """Mean per-clip loss over the ENTIRE evaluation set (default: val).

        The final short batch is right-padded to the full batch size by
        repeating its last clip, and the pad rows are masked out of the
        average: no clip is dropped and none counts twice. Runs under
        ``torch.no_grad``; the per-clip losses come to the host in one copy
        at the end. Under data parallelism each rank evaluates its rows of
        the padded batch and the ranks' per-clip losses are gathered back
        into the batch's order, so that every rank sums what one process
        sums."""
        cfg = self.cfg
        if cfg.device_corpus:
            return self._validate_indexed(dataset or self.val_dataset)
        refs = []
        with torch.no_grad():
            for batch in batch_iterator(
                dataset or self.val_dataset, cfg.batch_size, shuffle=False,
                drop_remainder=False,
            ):
                padded, real = pad_to_multiple(np.asarray(batch), cfg.batch_size)
                _, comps = self.eval_step(self._to_device(shard_batch(padded, self.mesh)))
                refs.append((gather_rows(comps["per_sample"], self.mesh), real))
        return self._mean_per_clip(refs)

    def _validate_indexed(self, ds: NSynthDataset) -> float:
        """Validation over an eval corpus placed on the device once: each
        batch sends B indices instead of B*T floats. The placed corpus is
        kept for the dataset it came from, held by a weak reference, so a
        later dataset (even one at the same address) gets its own."""
        cfg = self.cfg
        cached = self._val_corpus_ref() if self._val_corpus_ref is not None else None
        if cached is not ds:
            self._val_corpus_dev = device_corpus(np.asarray(ds.waveforms), self.device)
            self._val_corpus_ref = weakref.ref(ds)
        refs = []
        with torch.no_grad():
            for batch in index_iterator(
                ds, cfg.batch_size, shuffle=False, drop_remainder=False
            ):
                # Pad rows (repeats of the last index) are masked out of
                # the average, exactly like the array path.
                padded, real = pad_to_multiple(np.asarray(batch), cfg.batch_size)
                idx = self._to_device(shard_batch(padded, self.mesh))
                x = self._val_corpus_dev.index_select(0, idx[:, 0])[:, None, :]
                _, comps = self.eval_step(x)
                refs.append((gather_rows(comps["per_sample"], self.mesh), real))
        return self._mean_per_clip(refs)

    @staticmethod
    def _mean_per_clip(refs: list) -> float:
        """The mean of the real rows' per-clip losses of (per_sample, real)
        pairs, summed as the JAX package sums them."""
        if not refs:
            return 0.0
        drained = torch.stack([p for p, _ in refs]).cpu().numpy()
        total = sum(float(p[:real].sum()) for p, (_, real) in zip(drained, refs))
        count = sum(real for _, real in refs)
        return total / max(count, 1)

    def train(
        self, hyper_params: dict | None = None, resume: bool = False
    ) -> TrainingMetrics:
        """Full run, optionally preceded by grid tuning.

        ``resume=True`` picks up the ``latest`` checkpoint (params, optimizer
        state, step, metrics, epoch, curriculum epoch, host key) and
        reproduces the uninterrupted run: the steps draw from (run seed,
        step counter), the shuffle and sampling from (seed, epoch).
        """
        start_epoch = 0
        if resume and CheckpointManager(self.checkpoint_dir).exists("latest"):
            start_epoch = self.resume_from("latest") + 1
            hyper_params = None  # any tuning is already folded into the run
        if self.state is None:
            self.state = self.init_state()
        if hyper_params:
            self.tune_hyperparameters(hyper_params)
            self.load_best_parameters()

        cfg = self.cfg
        best_val = self.metrics.best_val_loss
        patience_counter = (
            max(0, (start_epoch - 1) - self.metrics.best_epoch)
            if start_epoch and self.metrics.best_epoch >= 0
            else 0
        )
        for epoch in range(start_epoch, cfg.max_epochs):
            train_loss = self.train_epoch(epoch)
            self.train_dataset.set_epoch(epoch)
            self.metrics.train_losses.append(train_loss)

            val_loss = self.validate()
            self.metrics.val_losses.append(val_loss)
            if self.writes:
                self.metrics.save(self.checkpoint_dir)

            names: tuple[str, ...] = ("latest",)
            if val_loss < best_val:
                best_val = val_loss
                self.metrics.best_val_loss = val_loss
                self.metrics.best_epoch = epoch
                patience_counter = 0
                names = ("best", "latest")  # identical state: ONE host copy
            else:
                patience_counter += 1
            if (
                patience_counter < cfg.patience
                and epoch % cfg.checkpoint_every_epochs == 0
            ):
                names = names + (f"epoch_{epoch}",)
            self.save_checkpoint(
                names, epoch=epoch, block=not cfg.async_checkpoint
            )
            if patience_counter >= cfg.patience:
                break
        self.finish_checkpoints()
        # Held-out evaluation with the best weights, scored exactly once.
        if self.test_dataset is not None:
            ckpt = CheckpointManager(self.checkpoint_dir)
            if ckpt.exists("best"):
                self._load_tree(ckpt.restore("best"))
            self.metrics.test_loss = self.validate(self.test_dataset)
            if self.writes:
                self.metrics.save(self.checkpoint_dir)
            self._barrier()
        return self.metrics

    # ------------------------------------------------------------ tuner

    def tune_hyperparameters_vmapped(self, hyper_params: dict) -> dict | None:
        """Grid search with every combo trained simultaneously as a vmap
        axis (see training/tuner.py): one step advances the whole grid. No
        per-combo checkpoint resume. Adopts the winning combo's parameters
        and learning rates and saves them as ``best_tuning``."""
        from .tuner import VmappedGridTuner

        cfg = self.cfg
        tuner = VmappedGridTuner(
            self.model,
            gradient_clip_val=cfg.gradient_clip_val,
            compute_dtype=torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32,
            mesh=self.mesh,  # the production run's mesh: grid replicated, batches split
        )
        # device_corpus: send [B, G] indices per step and gather the rows on
        # the device, exactly like the production train loop.
        make_iter = index_iterator if cfg.device_corpus else batch_iterator
        result = tuner.tune(
            hyper_params,
            train_batches=lambda e: make_iter(
                self.train_dataset, cfg.batch_size, seed=cfg.seed, epoch=e
            ),
            val_batches=lambda: make_iter(
                self.val_dataset, cfg.batch_size, shuffle=False
            ),
            epochs=cfg.tuning_epochs,
            seed=cfg.seed,
            initial_temp=cfg.initial_temp,
            min_temp=cfg.min_temp,
            temp_decay=cfg.temp_decay,
            corpus=self._step_corpus() if cfg.device_corpus else None,
            val_corpus=(
                self.val_dataset.waveforms if cfg.device_corpus else None
            ),
            scan_steps=cfg.scan_steps if cfg.device_corpus else 0,
        )
        best = result["best_params"]
        self.metrics.best_params = best
        if self.writes:
            self.metrics.save(self.checkpoint_dir)
        # adopt the winning combo's trained params as the starting point
        k = result["best_index"]
        self._build(
            best["encoder_lr"], best["decoder_lr"], best["complexity_penalty"]
        )
        self.state = self.init_state()
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                p.copy_(result["state"].params[name][k])
        self.save_checkpoint("best_tuning")
        return best

    def tune_hyperparameters(self, hyper_params: dict) -> dict | None:
        """Grid search with per-combo resume."""
        cfg = self.cfg
        best_val, best_params = float("inf"), None
        grid = itertools.product(
            hyper_params["encoder_lr"],
            hyper_params["decoder_lr"],
            hyper_params["complexity_penalty"],
        )
        for enc_lr, dec_lr, cpx in grid:
            combo_dir = self.checkpoint_dir / f"e{enc_lr}_d{dec_lr}_c{cpx}"
            combo_ckpt = CheckpointManager(combo_dir)
            self._build(enc_lr, dec_lr, cpx)

            latest = combo_ckpt.latest_epoch_name()
            # fresh seeded weights per combo, then the combo's own latest
            # checkpoint over them when it has one
            self.state = self.init_state()
            if latest is not None:
                self._load_tree(combo_ckpt.restore(latest))
                start_epoch = int(latest.split("_")[1]) + 1
            else:
                start_epoch = 0

            for epoch in range(start_epoch, cfg.tuning_epochs):
                self.train_epoch(epoch, sample_dir=combo_dir)
                val_loss = self.validate()
                self._save_combo(combo_ckpt, f"epoch_{epoch}")
                if val_loss < best_val:
                    best_val = val_loss
                    best_params = dict(self.hyper)
                    self._save_combo(combo_ckpt, "best")
                    self.save_checkpoint("best_tuning")

        self.metrics.best_params = best_params
        if self.writes:
            self.metrics.save(self.checkpoint_dir)
        return best_params

    def _save_combo(self, ckpt: CheckpointManager, name: str) -> None:
        """A tuner combo's checkpoint, written by rank 0, then a barrier."""
        if self.writes:
            ckpt.save(name, self._state_tree(), extra=self.hyper)
        self._barrier()

    def load_best_parameters(self) -> None:
        """Re-apply the winning combo + its weights."""
        p = self.metrics.best_params
        if p is None:
            return
        self._build(
            p["encoder_lr"], p["decoder_lr"], p["complexity_penalty"]
        )
        ckpt = CheckpointManager(self.checkpoint_dir)
        if ckpt.exists("best_tuning"):
            self._load_tree(ckpt.restore("best_tuning"))

    # ------------------------------------------------------------ io

    def save_checkpoint(
        self,
        name: str | tuple[str, ...],
        directory: Path | None = None,
        epoch: int | None = None,
        block: bool = True,
    ):
        """Checkpoint = state (params/optimizer state/step) + host sidecar.
        With ``epoch`` set, the sidecar carries the full resume payload:
        metrics, epoch, dataset curriculum epoch and the host key.

        ``name`` may be a tuple (e.g. ``("best", "latest")``): the state
        comes to the host ONCE and is written under every name.

        ``block=False`` clones the state on the device (and casts the
        moments there when ``checkpoint_moments_bf16``), then returns; a
        background thread copies the clone to the host on a side stream
        that waits for it, and writes. At most one save is in flight: the
        next save, ``finish_checkpoints`` and every restore join it first,
        re-raising its failure. Under data parallelism only rank 0 writes;
        every rank meets a barrier after a blocking write and in
        ``finish_checkpoints``."""
        extra = dict(self.hyper)
        # Architecture stamp: lets consumers rebuild the exact module.
        extra["model"] = self.model.geometry()
        cast_moments = self.cfg.checkpoint_moments_bf16
        if cast_moments:
            extra["moments_dtype"] = "bfloat16"
        if epoch is not None:
            extra["train_state"] = {
                "epoch": epoch,
                "metrics": asdict(self.metrics),
                "dataset_epoch": self.train_dataset.epoch,
                "rng_key": [int(w) for w in self.rng],
            }
        names = (name,) if isinstance(name, str) else name
        directory = directory or self.checkpoint_dir

        def _write(tree):
            ckpt = CheckpointManager(directory)
            host = to_host(tree)
            for n in names:
                ckpt.save(n, host, extra=extra)

        self.finish_checkpoints()
        if not self.writes:
            if block:
                self._barrier()  # rank 0's write below
            return
        if block:
            _write(self._state_tree(cast_moments=cast_moments))
            self._barrier()
            return
        snap = self._state_tree(clone=True, cast_moments=cast_moments)
        ready = stream = None
        if self.device.type == "cuda":
            if self._ckpt_stream is None:
                self._ckpt_stream = torch.cuda.Stream(self.device)
            stream = self._ckpt_stream
            ready = torch.cuda.Event()
            ready.record()  # after the clones, on the compute stream

        def _guarded():
            try:
                tree = snap
                if stream is not None:
                    stream.wait_event(ready)
                    with torch.cuda.stream(stream):
                        tree = to_host(snap)
                _write(tree)
            except BaseException as e:  # surfaced by finish_checkpoints
                self._ckpt_error = e

        self._ckpt_error = None
        self._ckpt_thread = threading.Thread(target=_guarded, name="ckpt-save")
        self._ckpt_thread.start()

    def finish_checkpoints(self):
        """Join the in-flight async checkpoint save, re-raising its error.

        Called before every restore (the newest snapshot must be durable
        first), before the next save, and at the end of ``train()``. Under
        data parallelism every rank then waits for the others."""
        t, self._ckpt_thread = self._ckpt_thread, None
        if t is not None:
            t.join()
            err, self._ckpt_error = self._ckpt_error, None
            if err is not None:
                raise err
        self._barrier()

    def load_checkpoint(self, name: str, directory: Path | None = None):
        """Restore a checkpoint into the live model and optimizer state (its
        moments back in their live dtypes) and rebuild the steps for the
        hyperparameters its sidecar names; returns the sidecar."""
        self.finish_checkpoints()  # the newest snapshot must be durable
        ckpt = CheckpointManager(directory or self.checkpoint_dir)
        if self.state is None:
            self.state = self.init_state()
        extra = ckpt.load_extra(name)
        self._load_tree(ckpt.restore(name))
        if extra:
            self._build(
                extra["encoder_lr"],
                extra["decoder_lr"],
                extra["complexity_penalty"],
            )
        return extra

    def resume_from(self, name: str, directory: Path | None = None) -> int:
        """Restore a full training snapshot; returns the completed epoch.

        Restores what ``load_checkpoint`` does plus metrics (early-stopping
        state), the dataset curriculum epoch (negative-sampling offset),
        and the host key: everything needed for the resumed trajectory to
        match the uninterrupted one."""
        extra = self.load_checkpoint(name, directory) or {}
        snap = extra.get("train_state")
        if not snap:
            return -1
        self.metrics = TrainingMetrics(**snap["metrics"])
        self.train_dataset.set_epoch(snap["dataset_epoch"])
        self.rng = [int(w) for w in snap["rng_key"]]
        return int(snap["epoch"])

    def _dump_audio(self, epoch: int, iteration: int, batch):
        """Input/output wav dump + complex-size metadata, from the
        deterministic eval forward (``train=False``)."""
        cfg = self.cfg
        batch = torch.as_tensor(batch)
        if batch.ndim == 2:  # index batch (device-corpus path) -> anchor row
            rows = batch[:1, 0].cpu().numpy()
            x = torch.from_numpy(np.asarray(self.train_dataset.waveforms)[rows])[:, None, :]
        else:
            x = batch[:1, 0] if batch.ndim == 4 else batch[:1]
        x = x.to(self.device, torch.float32)
        with torch.no_grad():
            out = self.model(x, 1.0, train=False)
        d = self.checkpoint_dir / f"samples/epoch_{epoch}_iter_{iteration}"
        d.mkdir(parents=True, exist_ok=True)
        save_wav(d / f"input_{iteration}.wav", x[0].cpu().numpy(), cfg.sample_rate)
        save_wav(
            d / f"output_{iteration}.wav",
            out.waveform[0].cpu().numpy(),
            cfg.sample_rate,
        )
        masks = out.encoder_output.masks
        meta = {
            "complex_data": {
                "num_vertices": int(masks[0][0].sum()),
                "num_edges": int(masks[1][0].sum()),
                "num_triangles": int(masks[2][0].sum()),
                "num_tetra": int(masks[3][0].sum()),
            }
        }
        (d / f"metadata_{iteration}.json").write_text(json.dumps(meta, indent=2))
