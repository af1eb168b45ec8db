"""Training state, optimizer, and the single-device and sharded train steps.

Port of ``tacotron_multispeaker_tpu/training.py`` (``learning_rate_schedule``,
``make_optimizer``, ``create_train_state``, ``make_train_step``,
``make_shard_map_train_step``, ``sharded_speaker_embed``,
``make_hybrid_train_step``, ``make_sharded_train_step``).  The optimizer is
the reference's: gradients clipped by their global norm (1.0) BEFORE
Adam(β1 0.9, β2 0.999, ε 1e-6, ε outside the square root, bias-corrected),
scaled by the warmup + rsqrt ("noam") schedule
``lr = init·sqrt(warmup)·min(s·warmup^-1.5, s^-0.5)`` with s = step + 1.

The JAX step is a pure function of an immutable state; here the state holds
the model (parameters and BatchNorm running statistics) and the optimizer,
and a step updates them in place.  Prenet dropout draws from a
``torch.Generator`` seeded from (seed, step), as the JAX step folds the step
into its key.  With ``train.targets_from_wav`` the step derives its
spectrogram targets from the batch's int16 PCM (:func:`derive_wav_targets`).
``train.adam_mu_dtype=bfloat16`` keeps Adam's first moment in bfloat16, as
optax's ``scale_by_adam(mu_dtype=)`` does (:class:`Optimizer`).

Sharded training runs one process per position of a (data, model) mesh of
ranks (parallel/).  Every rank calls the step on its own slice of each
global batch (:func:`batch_slice`) and the collectives are explicit, as in
the JAX package's ``shard_map`` steps: :func:`make_data_parallel_train_step`
for a trivial model axis, :func:`make_hybrid_train_step` for a speaker table
whose rows shard over ``model`` (the batch over data × model, or over
``data`` alone, the ranks of a mesh row then computing the same rows: the
JAX package's GSPMD route), routed by :func:`make_sharded_train_step` as the
JAX package routes.  Every kernel runs on each rank's local batch.
:func:`sharded_speaker_embed` (the differentiable lookup from the row-sharded
table) also serves the sharded synthesis of synthesizer.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from .audio import dsp
from .config import Config
from .device import resolve_device
from .models import Tacotron, create_model, tacotron_loss
from .parallel.distributed import (all_gather, all_reduce, all_reduce_coalesced,
                                   all_reduce_scalars, psum)
from .parallel.mesh import Mesh, keep_shards, param_shards


def learning_rate_schedule(cfg: Config):
    """step (int, the count of updates so far) → learning rate (float)."""
    tr = cfg.train
    init_lr, warmup = tr.initial_learning_rate, tr.warmup_steps

    def schedule(step: int) -> float:
        if not tr.decay_learning_rate:
            return init_lr
        s = max(step + 1.0, 1.0)
        return init_lr * warmup ** 0.5 * min(s * warmup ** -1.5, s ** -0.5)

    return schedule


def _grads(params) -> list[torch.Tensor]:
    """The ``.grad`` of each parameter, zeros where there is none (as
    ``jax.grad`` gives them)."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return [p.grad for p in params]


class Optimizer:
    """optax ``chain(clip_by_global_norm, scale_by_adam, scale_by_schedule,
    scale(-1))`` over ``params``.  ``torch.optim.Adam`` carries the moments
    and makes the f32 update.  With ``train.adam_mu_dtype=bfloat16`` the
    first moment is kept in bfloat16, which ``torch.optim.Adam`` cannot
    do, so the update is written out here in optax's order
    (:meth:`_low_mu_update`); the state keeps ``torch.optim``'s layout
    (``state[i] = {step, exp_avg, exp_avg_sq}``, ``exp_avg`` bf16), so
    checkpoints and their gathers over a mesh take it unchanged."""

    def __init__(self, cfg: Config, params):
        tr = cfg.train
        if tr.adam_mu_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"train.adam_mu_dtype={tr.adam_mu_dtype!r}: float32 or bfloat16")
        self.mu_dtype = torch.bfloat16 if tr.adam_mu_dtype == "bfloat16" else None
        self.params = [p for p in params if p.requires_grad]
        self.max_norm = tr.grad_clip_norm
        self.schedule = learning_rate_schedule(cfg)
        self.adam = torch.optim.Adam(self.params, lr=self.schedule(0),
                                     betas=(tr.adam_beta1, tr.adam_beta2), eps=tr.adam_eps)

    @torch.no_grad()
    def step(self, count: int, norm: torch.Tensor | None = None) -> torch.Tensor:
        """Clip the ``.grad`` of every parameter (a missing one counts as
        zeros) by the global norm and apply one Adam update with the
        learning rate of update ``count``.  ``norm``: the global gradient
        norm where the caller computed it across ranks (the hybrid step,
        whose table gradient is sharded: the JAX package's ``clip=False``
        chain after a clip by hand); None takes it from these gradients.
        Returns the norm before clipping (a 0-dim f32 tensor; no host
        sync)."""
        grads = _grads(self.params)
        if norm is None:
            norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
        # optax: select(norm < max, g, g / norm * max)
        keep = norm < self.max_norm
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm * self.max_norm))
        lr = self.schedule(count)
        if self.mu_dtype is None:
            for group in self.adam.param_groups:
                group["lr"] = lr
            self.adam.step()
        else:
            self._low_mu_update(lr)
        return norm

    def _low_mu_update(self, lr: float) -> None:
        """optax ``scale_by_adam(mu_dtype=bf16)`` then the schedule's scale:
        mu = (1−b1)·g + b1·mu_bf16, the second product in bf16 (JAX rounds
        the weakly typed b1 to the moment's dtype); nu = (1−b2)·g² + b2·nu;
        the update mu/(1−b1^n) / (sqrt(nu/(1−b2^n)) + eps) from the
        unrounded f32 mu, the bias corrections in f32; only then is mu
        stored rounded to bf16."""
        group = self.adam.param_groups[0]
        (b1, b2), eps = group["betas"], group["eps"]
        b1_low = torch.tensor(b1, dtype=self.mu_dtype)
        f32 = np.float32
        for p in self.params:
            st = self.adam.state[p]
            if not st:
                st["step"] = torch.tensor(0.0)
                st["exp_avg"] = torch.zeros_like(p, dtype=self.mu_dtype)
                st["exp_avg_sq"] = torch.zeros_like(p)
            st["step"] += 1
            n = f32(st["step"].item())
            bc1 = float(f32(1.0) - np.power(f32(b1), n))
            bc2 = float(f32(1.0) - np.power(f32(b2), n))
            g = p.grad
            mu = g * (1.0 - b1) + (st["exp_avg"] * b1_low).float()
            nu = g * g * (1.0 - b2) + st["exp_avg_sq"] * b2
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
            p.sub_(update * lr)
            st["exp_avg"].copy_(mu)
            st["exp_avg_sq"].copy_(nu)

    def state_dict(self) -> dict:
        """The Adam moments and step counts (``torch.optim`` layout)."""
        return self.adam.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state)
        if self.mu_dtype is not None:
            # torch.optim casts every moment to its parameter's dtype on load;
            # the step count stays a host scalar (read without a device sync)
            for st in self.adam.state.values():
                st["exp_avg"] = st["exp_avg"].to(self.mu_dtype)
                st["step"] = st["step"].float().cpu()


def make_optimizer(cfg: Config, params) -> Optimizer:
    """Clip by global norm → Adam → noam schedule, over ``params``."""
    return Optimizer(cfg, params)


@dataclass
class TrainState:
    """What the JAX ``TrainState`` holds: the update count, the parameters
    and BatchNorm statistics (in ``model``), the optimizer state (in
    ``optimizer``) and the dropout seed; and, for a rank of a mesh, the
    mesh and the parameters it keeps in part (``parallel.param_shards``)."""
    step: int
    model: Tacotron
    optimizer: Optimizer
    seed: int
    mesh: Mesh | None = None
    shards: dict[str, slice] = field(default_factory=dict)


def train_route(cfg: Config, mesh: Mesh | None) -> str:
    """The step :func:`make_sharded_train_step` builds for ``mesh``, as the
    JAX ``make_sharded_train_step`` routes: "single" (one rank),
    "data_parallel" (a trivial model axis), "hybrid" (``hybrid_model_axis``,
    the table rows divisible by the model axis and the batch by the mesh
    size: the batch over data × model) or "replicated" (the rest: the batch
    over ``data`` only, the ranks of a mesh row computing the same rows)."""
    if mesh is None or mesh.size == 1:
        return "single"
    if mesh.model == 1:
        return "data_parallel"
    if (cfg.parallel.hybrid_model_axis
            and (not _shard_table(cfg) or cfg.model.num_speakers % mesh.model == 0)
            and cfg.train.batch_size % mesh.size == 0):
        return "hybrid"
    return "replicated"


def batch_slice(cfg: Config, mesh: Mesh | None) -> tuple[int, int]:
    """(index, count): this rank's step takes the ``index``-th of ``count``
    contiguous slices of every global batch (the Feeder's
    ``process_index`` / ``process_count``).  The ranks of a mesh row take
    the same slice on the "replicated" route."""
    route = train_route(cfg, mesh)
    if route == "single":
        return 0, 1
    if route == "hybrid":
        return mesh.rank, mesh.size
    return mesh.data_index, mesh.data


def _bn_group(cfg: Config, mesh: Mesh | None, route: str | None = None):
    """The process group of the BatchNorms' statistics on ``route``
    (default: ``mesh``'s): per rank (None) unless
    ``parallel.bn_cross_replica``, and always the whole mesh on the
    "replicated" route (the GSPMD step's global-batch statistics)."""
    route = route or train_route(cfg, mesh)
    if route == "replicated" or (route != "single" and cfg.parallel.bn_cross_replica):
        return mesh.data_group if route == "data_parallel" else mesh.world_group
    return None


def create_train_state(cfg: Config, seed: int = 0, device=None,
                       mesh: Mesh | None = None) -> tuple[Tacotron, TrainState]:
    """Model with random weights from ``seed`` (flax's initialisers), in
    training mode, and its optimizer.  ``device=None`` is the CUDA device
    (raises without one); ``device="cpu"`` runs the plain PyTorch path.
    ``mesh``: this process is one rank of the mesh, on the mesh's device; it
    keeps only its rows of the parameters that shard (the speaker table's
    rows of the full table drawn from ``seed``) and its BatchNorms take the
    route's statistics group."""
    if mesh is not None and device is not None and torch.device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's {mesh.device}")
    dev = resolve_device(mesh.device if mesh is not None else device)
    shards = param_shards(cfg, mesh) if mesh is not None else {}
    model = create_model("tacotron", cfg, bn_group=_bn_group(cfg, mesh)).reset_parameters(
        torch.Generator().manual_seed(seed))
    model = keep_shards(model, shards).to(dev).train()
    return model, TrainState(step=0, model=model,
                             optimizer=make_optimizer(cfg, model.parameters()), seed=seed,
                             mesh=mesh, shards=shards)


def fold_in(seed: int, index: int) -> int:
    """A seed of its own for (seed, index) (``jax.random.fold_in``'s part)."""
    return (seed * 1_000_003 + index) % (2 ** 63 - 1)


def _fold_generator(seed: int, index: int, device: torch.device) -> torch.Generator:
    """A generator of its own for (seed, index): a train step, or a batch
    shard of the sharded synthesis."""
    return torch.Generator(device=device).manual_seed(fold_in(seed, index))


def derive_wav_targets(wav_targets: torch.Tensor, cfg: Config) -> tuple[torch.Tensor,
                                                                        torch.Tensor]:
    """[B, T*hop] int16 PCM -> (mel [B, T, M], linear [B, T, bins]) float32
    targets (``train.targets_from_wav``): the step computes its own
    targets from the waveform (audio/dsp.py spectrogram_targets), so the
    host ships ~8x fewer bytes a frame.  ``train.wav_dft_precision=high``
    (bf16x3 products on the TPU) runs float32 products too: PyTorch has no
    bf16x3 mode."""
    params = dsp.STFTParams.from_config(cfg.audio)
    a = cfg.audio
    return dsp.spectrogram_targets(
        wav_targets.float() / 32768.0, params, sample_rate=a.sample_rate,
        num_mels=a.num_mels, preemph=a.preemphasis, ref_level_db=a.ref_level_db,
        min_level_db=a.min_level_db, n_frames=wav_targets.shape[-1] // params.hop_length)


def _make_loss_fn(cfg: Config, model: Tacotron, *, group=None, speaker_embed_fn=None):
    """The one loss body every step shares (the JAX ``_make_loss_fn``):
    ``(generator, *batch) -> losses``.  The targets derived from the PCM
    under ``train.targets_from_wav``, the speaker vectors (the model's own
    table lookup, or ``speaker_embed_fn(ids)`` for a sharded table), the
    teacher-forced pass and the loss: this rank's share of the loss of
    ``group``'s batch (models/losses.py)."""
    tr = cfg.train
    n_speakers = cfg.model.num_speakers

    def loss_fn(generator, inputs, input_lengths, mel_targets, linear_targets,
                target_lengths, speaker_ids) -> dict:
        if tr.targets_from_wav:
            with torch.no_grad():
                mel_targets, linear_targets = derive_wav_targets(mel_targets, cfg)
        if speaker_embed_fn is not None:
            kw = dict(speaker_embed=speaker_embed_fn(speaker_ids))
        else:
            kw = dict(speaker_ids=speaker_ids if n_speakers > 1 else None)
        out = model(inputs, input_lengths, mel_targets, generator=generator, **kw)
        return tacotron_loss(
            out.mel_outputs, out.linear_outputs, mel_targets, linear_targets,
            target_lengths if tr.loss_masking else None, num_freq=cfg.audio.num_freq,
            sample_rate=cfg.audio.sample_rate, prioritize_hz=tr.prioritize_freq_hz,
            group=group, fused_linear=tr.fused_linear_loss)

    return loss_fn


def _start_step(state: TrainState) -> None:
    state.model.train()
    for p in state.optimizer.params:
        p.grad = None


def _finish_step(state: TrainState, losses: dict, grad_norm: torch.Tensor,
                 schedule) -> tuple[TrainState, dict]:
    metrics = {k: v.detach() for k, v in losses.items()}
    metrics.update(grad_norm=grad_norm, lr=schedule(state.step))
    state.step += 1
    return state, metrics


def make_train_step(cfg: Config, model: Tacotron):
    """The step ``(state, inputs, input_lengths, mel_targets, linear_targets,
    target_lengths, speaker_ids) -> (state, metrics)``, batches in the
    Feeder's layout (with ``train.targets_from_wav``: the PCM in
    ``mel_targets``, ``linear_targets`` unused).  Metrics (0-dim f32
    tensors, read without a host sync inside the step): loss, mel_loss,
    linear_loss, grad_norm (before clipping), and lr (float), the rate this
    update used."""
    schedule = learning_rate_schedule(cfg)
    loss_fn = _make_loss_fn(cfg, model)

    def train_step(state: TrainState, *batch):
        _start_step(state)
        losses = loss_fn(_fold_generator(state.seed, state.step, batch[0].device), *batch)
        losses["loss"].backward()
        return _finish_step(state, losses, state.optimizer.step(state.step), schedule)

    return train_step


@torch.no_grad()
def _average_running_stats(model: Tacotron, group) -> None:
    """The BatchNorms' running statistics averaged over ``group`` in one
    all-reduce (the JAX step's one ``pmean`` of ``batch_stats``)."""
    stats = [t for bn in model.batch_norms() for t in (bn.mean, bn.var)]
    all_reduce_coalesced(stats, group)
    n = dist.get_world_size(group)
    for t in stats:
        t.div_(n)


def make_data_parallel_train_step(cfg: Config, model: Tacotron, mesh: Mesh):
    """The data-parallel step over a mesh with a trivial model axis (the
    JAX ``make_shard_map_train_step``): ``make_train_step``'s signature,
    called by every rank with its slice of the global batch.

    * dropout from (seed, step, data index), so the ranks draw different
      masks;
    * the loss is this rank's share over the group's denominator
      (models/losses.py ``group``), so the SUM of the ranks' gradients is
      the whole batch's: one coalesced all-reduce of the gradients, then
      one of the loss scalars;
    * BatchNorm statistics per rank, the running statistics averaged once
      a step; with ``parallel.bn_cross_replica`` the statistics of the
      whole batch (the BatchNorms' own differentiable all-reduce);
    * the grad norm and the clip taken after the all-reduce
      (``optax.global_norm(psum(grads))``)."""
    if mesh.model != 1:
        raise ValueError(f"the data-parallel step needs a trivial model axis, not {mesh.model}")
    group = mesh.data_group
    bn_group = _bn_group(cfg, mesh, "data_parallel")
    model.set_bn_group(bn_group)
    schedule = learning_rate_schedule(cfg)
    loss_fn = _make_loss_fn(cfg, model, group=group)

    def train_step(state: TrainState, *batch):
        _start_step(state)
        gen = _fold_generator(fold_in(state.seed, state.step), mesh.data_index,
                              batch[0].device)
        losses = loss_fn(gen, *batch)
        losses["loss"].backward()
        all_reduce_coalesced(_grads(state.optimizer.params), group)
        losses = all_reduce_scalars(losses, group)
        if bn_group is None:
            _average_running_stats(model, group)
        return _finish_step(state, losses, state.optimizer.step(state.step), schedule)

    return train_step


def sharded_speaker_embed(table: torch.Tensor, first_row: int, speaker_ids: torch.Tensor,
                          mesh, batch_sharded: bool = True) -> torch.Tensor:
    """[B_local] ids → [B_local, E] speaker vectors from a table whose rows
    shard over the mesh's ``model`` axis: this rank holds ``table``, rows
    ``first_row …`` of the full table (mesh.param_shards).

    ``batch_sharded`` (the ranks of a mesh row hold different batch rows):
    the ids are all-gathered over ``model``, each rank gathers the ids that
    fall in its rows (zeros elsewhere), a SUM over ``model`` assembles every
    vector, and the rank keeps its own ``B_local`` segment.  Otherwise (ids
    the same across the row) only the masked gather and the SUM run.
    Differentiable: the SUM's backward sums the cotangents over ``model``
    and the gather scatters them onto the rows this rank owns, which is the
    sharded table's gradient.  Port of ``training.py
    sharded_speaker_embed``."""
    group = mesh.model_group
    b_local = speaker_ids.shape[0]
    ids = all_gather(speaker_ids, 0, group) if batch_sharded else speaker_ids
    rel = ids - first_row
    s_local = table.shape[0]
    if s_local:
        ok = (rel >= 0) & (rel < s_local)
        emb = torch.where(ok[:, None], table[rel.clamp(0, s_local - 1)], 0.0)
    else:                                   # an empty last shard (S < M·ceil(S/M))
        emb = table.new_zeros((ids.shape[0], table.shape[1]))
    emb = psum(emb, group)
    if batch_sharded:
        j = mesh.model_index
        emb = emb[j * b_local:(j + 1) * b_local]
    return emb


def _shard_table(cfg: Config) -> bool:
    return (cfg.model.num_speakers > 1
            and cfg.parallel.model_parallel_size > 1
            and cfg.model.num_speakers >= cfg.parallel.shard_speaker_table_min)


def make_hybrid_train_step(cfg: Config, model: Tacotron, mesh: Mesh,
                           batch_sharded: bool = True):
    """The step over both mesh axes (the JAX ``make_hybrid_train_step``),
    the speaker table's rows sharded over ``model`` (``param_shards``; the
    model made by ``create_train_state(cfg, mesh=mesh)``).

    ``batch_sharded``: the batch shards over data × model, and each rank
    takes its speakers' vectors through :func:`sharded_speaker_embed`.
    Otherwise the batch shards over ``data`` only and the ranks of a mesh
    row compute the same rows (the JAX package's GSPMD route, its kernels
    on here): the same arithmetic, each rank's share of the loss 1/model of
    its row's, and the BatchNorms always take the statistics of the whole
    mesh (the GSPMD step's statistics of the global batch).

    * the loss is this rank's share over the whole mesh's denominator;
    * the table's gradient is summed over ``data`` (the ranks holding the
      same rows), every other gradient over the whole mesh: one coalesced
      all-reduce a group;
    * the clip by hand with the global norm: the replicated gradients'
      square-sum plus the table's, summed over ``model``
      (``Optimizer.step(norm=)``);
    * dropout from (seed, step, rank), or (seed, step, data index) when the
      rows are replicated;
    * BatchNorm as the data-parallel step's, over the whole mesh."""
    if mesh.model == 1:
        raise ValueError("the hybrid step needs a non-trivial model axis")
    world = mesh.world_group
    shards = param_shards(cfg, mesh)
    table = None
    if shards:
        rows = shards["speaker_table.weight"]
        table = model.speaker_table.weight
        if table.shape[0] != rows.stop - rows.start:
            raise ValueError(f"the speaker table holds {table.shape[0]} rows, this rank's "
                             f"shard {rows.stop - rows.start}: make the state with "
                             "create_train_state(cfg, mesh=mesh)")
    bn_group = _bn_group(cfg, mesh, "hybrid" if batch_sharded else "replicated")
    model.set_bn_group(bn_group)
    schedule = learning_rate_schedule(cfg)
    embed = None if table is None else (
        lambda ids: sharded_speaker_embed(table, rows.start, ids, mesh, batch_sharded))
    loss_fn = _make_loss_fn(cfg, model, group=world, speaker_embed_fn=embed)
    shard_index = mesh.rank if batch_sharded else mesh.data_index

    def train_step(state: TrainState, *batch):
        _start_step(state)
        gen = _fold_generator(fold_in(state.seed, state.step), shard_index, batch[0].device)
        losses = loss_fn(gen, *batch)
        losses["loss"].backward()
        params = state.optimizer.params
        grads = _grads(params)
        rep = [g for p, g in zip(params, grads) if p is not table]
        tab = [g for p, g in zip(params, grads) if p is table]
        all_reduce_coalesced(rep, world)
        all_reduce_coalesced(tab, mesh.data_group)
        losses = all_reduce_scalars(losses, world)
        if bn_group is None:
            _average_running_stats(model, world)
        with torch.no_grad():
            square_sum = lambda gs: sum(g.float().square().sum() for g in gs)
            sq = square_sum(rep)
            if tab:
                sq = sq + all_reduce(square_sum(tab), "sum", mesh.model_group)
            norm = torch.sqrt(sq)
        return _finish_step(state, losses, state.optimizer.step(state.step, norm=norm),
                            schedule)

    return train_step


def make_sharded_train_step(cfg: Config, model: Tacotron, mesh: Mesh | None):
    """The train step for this rank of ``mesh``, routed by
    :func:`train_route`: today's single-device step on a mesh of one, the
    data-parallel step, or the hybrid step with the batch over data × model
    ("hybrid") or over ``data`` only ("replicated").  Every rank calls it
    and then the step, each with its :func:`batch_slice` of the global
    batch; a rank that skips a step hangs the others in a collective."""
    route = train_route(cfg, mesh)
    if route == "single":
        return make_train_step(cfg, model)
    if route == "data_parallel":
        return make_data_parallel_train_step(cfg, model, mesh)
    return make_hybrid_train_step(cfg, model, mesh, batch_sharded=route == "hybrid")
