"""The reference's training step: the loss of ``model.Tacotron.forward``,
its gradients by autograd, the gradients clipped by their global norm, and
Adam (bias-corrected, eps outside the square root) at the warm-up / rsqrt
learning-rate schedule, all in float32."""

from __future__ import annotations

import torch

from . import model as rmodel


def learning_rate(step: int, tr: dict) -> float:
    """Rate of update ``step`` (0-based): init·sqrt(w)·min(s·w^-1.5, s^-0.5), s = step + 1."""
    if not tr["decay_learning_rate"]:
        return tr["initial_learning_rate"]
    s, w = step + 1.0, tr["warmup_steps"]
    return tr["initial_learning_rate"] * w ** 0.5 * min(s * w ** -1.5, s ** -0.5)


class Trainer:
    """``params`` {name: leaf} are updated in place; ``buffers`` the rest of W."""

    def __init__(self, params: dict, buffers: dict, dims: dict, q):
        self.params, self.buffers, self.dims, self.q = params, buffers, dims, q
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.count = 0

    def step(self, inputs, lengths, mel_t, linear_t, target_lengths, sids, draw):
        """One update → (loss, the clipped gradients {name: tensor})."""
        tr = self.dims["train"]
        names = list(self.params)
        leaves = [self.params[n].detach().requires_grad_(True) for n in names]
        W = {**self.buffers, **dict(zip(names, leaves))}
        ref = rmodel.Tacotron(W, self.dims, self.q)
        mel, lin = ref.forward(inputs, lengths, mel_t, sids, draw)
        loss = rmodel.loss(mel, lin, mel_t, linear_t, target_lengths, self.dims)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        norm = torch.sqrt(sum(g.square().sum() for g in grads))
        if norm >= tr["grad_clip_norm"]:
            grads = [g / norm * tr["grad_clip_norm"] for g in grads]
        self.count += 1
        b1, b2, eps = tr["adam_beta1"], tr["adam_beta2"], tr["adam_eps"]
        lr = learning_rate(self.count - 1, tr)
        with torch.no_grad():
            for n, g in zip(names, grads):
                self.m[n].mul_(b1).add_(g, alpha=1 - b1)
                self.v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                mh = self.m[n] / (1 - b1 ** self.count)
                vh = self.v[n] / (1 - b2 ** self.count)
                self.params[n] = self.params[n] - lr * mh / (vh.sqrt() + eps)
        return float(loss.detach()), dict(zip(names, grads))
