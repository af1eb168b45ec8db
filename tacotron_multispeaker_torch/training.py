"""Training state, optimizer and the single-device train step.

Port of ``tacotron_multispeaker_tpu/training.py`` (``learning_rate_schedule``,
``make_optimizer``, ``create_train_state``, ``make_train_step``).  The
optimizer is the reference's: gradients clipped by their global norm (1.0)
BEFORE Adam(β1 0.9, β2 0.999, ε 1e-6, ε outside the square root,
bias-corrected), scaled by the warmup + rsqrt ("noam") schedule
``lr = init·sqrt(warmup)·min(s·warmup^-1.5, s^-0.5)`` with s = step + 1.

The JAX step is a pure function of an immutable state; here the state holds
the model (parameters and BatchNorm running statistics) and the optimizer,
and a step updates them in place.  Prenet dropout draws from a
``torch.Generator`` seeded from (seed, step), as the JAX step folds the step
into its key.  With ``train.targets_from_wav`` the step derives its
spectrogram targets from the batch's int16 PCM (:func:`derive_wav_targets`).
The data-parallel and hybrid steps and ``train.adam_mu_dtype=bfloat16`` are
not ported yet (ROADMAP.md).
:func:`sharded_speaker_embed` (the lookup from a row-sharded speaker table)
serves the sharded synthesis of synthesizer.py.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .audio import dsp
from .config import Config
from .device import resolve_device
from .models import Tacotron, create_model, tacotron_loss
from .parallel.distributed import all_gather, all_reduce


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


class Optimizer:
    """optax ``chain(clip_by_global_norm, scale_by_adam, scale_by_schedule,
    scale(-1))`` over ``params``; ``torch.optim.Adam`` carries the moments."""

    def __init__(self, cfg: Config, params):
        tr = cfg.train
        if tr.adam_mu_dtype != "float32":
            raise NotImplementedError(
                f"train.adam_mu_dtype={tr.adam_mu_dtype!r} is not ported yet "
                "(ROADMAP.md, 'train.adam_mu_dtype=bfloat16')")
        self.params = [p for p in params if p.requires_grad]
        self.max_norm = tr.grad_clip_norm
        self.schedule = learning_rate_schedule(cfg)
        self.adam = torch.optim.Adam(self.params, lr=self.schedule(0),
                                     betas=(tr.adam_beta1, tr.adam_beta2), eps=tr.adam_eps)

    @torch.no_grad()
    def step(self, count: int) -> torch.Tensor:
        """Clip the ``.grad`` of every parameter (a missing one counts as
        zeros, as ``jax.grad`` gives them) and apply one Adam update with
        the learning rate of update ``count``.  Returns the global gradient
        norm before clipping (a 0-dim f32 tensor; no host sync)."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
        # optax: select(norm < max, g, g / norm * max)
        keep = norm < self.max_norm
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm * self.max_norm))
        for group in self.adam.param_groups:
            group["lr"] = self.schedule(count)
        self.adam.step()
        return norm

    def state_dict(self) -> dict:
        """The Adam moments and step counts (``torch.optim`` layout)."""
        return self.adam.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state)


def make_optimizer(cfg: Config, params) -> Optimizer:
    """Clip by global norm → Adam → noam schedule, over ``params``."""
    return Optimizer(cfg, params)


@dataclass
class TrainState:
    """What the JAX ``TrainState`` holds: the update count, the parameters
    and BatchNorm statistics (in ``model``), the optimizer state (in
    ``optimizer``) and the dropout seed."""
    step: int
    model: Tacotron
    optimizer: Optimizer
    seed: int


def create_train_state(cfg: Config, seed: int = 0, device=None) -> tuple[Tacotron, TrainState]:
    """Model with random weights from ``seed`` (flax's initialisers), in
    training mode, and its optimizer.  ``device=None`` is the CUDA device
    (raises without one); ``device="cpu"`` runs the plain PyTorch path."""
    dev = resolve_device(device)
    model = create_model("tacotron", cfg).reset_parameters(
        torch.Generator().manual_seed(seed)).to(dev).train()
    return model, TrainState(step=0, model=model,
                             optimizer=make_optimizer(cfg, model.parameters()), seed=seed)


def _fold_generator(seed: int, index: int, device: torch.device) -> torch.Generator:
    """A generator of its own for (seed, index): a train step, or a batch
    shard of the sharded synthesis (``jax.random.fold_in``'s part)."""
    return torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + index) % (2 ** 63 - 1))


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


def make_train_step(cfg: Config, model: Tacotron):
    """The step ``(state, inputs, input_lengths, mel_targets, linear_targets,
    target_lengths, speaker_ids) -> (state, metrics)``, batches in the
    Feeder's layout (with ``train.targets_from_wav``: the PCM in
    ``mel_targets``, ``linear_targets`` unused).  Metrics (0-dim f32
    tensors, read without a host sync inside the step): loss, mel_loss,
    linear_loss, grad_norm (before clipping), and lr (float), the rate this
    update used."""
    tr = cfg.train
    schedule = learning_rate_schedule(cfg)
    n_speakers = cfg.model.num_speakers

    def train_step(state: TrainState, inputs, input_lengths, mel_targets, linear_targets,
                   target_lengths, speaker_ids):
        model.train()
        dev = inputs.device
        for p in state.optimizer.params:
            p.grad = None
        if tr.targets_from_wav:
            with torch.no_grad():
                mel_targets, linear_targets = derive_wav_targets(mel_targets, cfg)
        out = model(inputs, input_lengths, mel_targets,
                    speaker_ids if n_speakers > 1 else None,
                    generator=_fold_generator(state.seed, state.step, dev))
        losses = tacotron_loss(
            out.mel_outputs, out.linear_outputs, mel_targets, linear_targets,
            target_lengths if tr.loss_masking else None, num_freq=cfg.audio.num_freq,
            sample_rate=cfg.audio.sample_rate, prioritize_hz=tr.prioritize_freq_hz,
            fused_linear=tr.fused_linear_loss)
        losses["loss"].backward()
        grad_norm = state.optimizer.step(state.step)
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics.update(grad_norm=grad_norm, lr=schedule(state.step))
        state.step += 1
        return state, metrics

    return train_step


def sharded_speaker_embed(table: torch.Tensor, first_row: int, speaker_ids: torch.Tensor,
                          mesh, batch_sharded: bool = True) -> torch.Tensor:
    """[B_local] ids → [B_local, E] speaker vectors from a table whose rows
    shard over the mesh's ``model`` axis: this rank holds ``table``, rows
    ``first_row …`` of the full table (mesh.param_shards).

    ``batch_sharded`` (the hybrid decode, where the ranks of a mesh row hold
    different batch rows): the ids are all-gathered over ``model``, each
    rank gathers the ids that fall in its rows (zeros elsewhere), a SUM over
    ``model`` assembles every vector, and the rank keeps its own
    ``B_local`` segment.  Otherwise (the sequence-sharded decode, ids the
    same across the row) only the masked gather and the SUM run.  Port of
    ``training.py sharded_speaker_embed``; inference only."""
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
    emb = all_reduce(emb, "sum", group)
    if batch_sharded:
        j = mesh.model_index
        emb = emb[j * b_local:(j + 1) * b_local]
    return emb


def _shard_table(cfg: Config) -> bool:
    return (cfg.model.num_speakers > 1
            and cfg.parallel.model_parallel_size > 1
            and cfg.model.num_speakers >= cfg.parallel.shard_speaker_table_min)
