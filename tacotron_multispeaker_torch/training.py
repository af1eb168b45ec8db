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
into its key.  The data-parallel and hybrid steps, ``train.targets_from_wav``
and ``train.adam_mu_dtype=bfloat16`` are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .config import Config
from .device import resolve_device
from .models import Tacotron, create_model, tacotron_loss


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


def _step_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + step) % (2 ** 63 - 1))


def make_train_step(cfg: Config, model: Tacotron):
    """The step ``(state, inputs, input_lengths, mel_targets, linear_targets,
    target_lengths, speaker_ids) -> (state, metrics)``, batches in the
    Feeder's layout.  Metrics (0-dim f32 tensors, read without a host sync
    inside the step): loss, mel_loss, linear_loss, grad_norm (before
    clipping), and lr (float), the rate this update used."""
    if cfg.train.targets_from_wav:
        raise NotImplementedError("train.targets_from_wav is not ported yet (ROADMAP.md, "
                                  "'Data + loop': the STFT analysis side)")
    tr = cfg.train
    schedule = learning_rate_schedule(cfg)
    n_speakers = cfg.model.num_speakers

    def train_step(state: TrainState, inputs, input_lengths, mel_targets, linear_targets,
                   target_lengths, speaker_ids):
        model.train()
        dev = inputs.device
        for p in state.optimizer.params:
            p.grad = None
        out = model(inputs, input_lengths, mel_targets,
                    speaker_ids if n_speakers > 1 else None,
                    generator=_step_generator(state.seed, state.step, dev))
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
