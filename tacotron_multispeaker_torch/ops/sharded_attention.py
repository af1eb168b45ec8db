"""Sequence-sharded attention step: the distributed softmax over the
``model`` axis.

Port of ``tacotron_multispeaker_tpu/ops/sharded_attention.py``
``make_sharded_attention_step``.  Each rank of a mesh row holds the keys
[B, L/M, A], memory [B, L/M, D] and mask [B, L/M] of its slice of the
encoder length; the query [B, A] and ``v`` [A] are the same on every rank.
A step computes the local partial (kernel 10,
:func:`.attention_step.attention_step_partial`) and combines it across the
row: the global max, the rescaled sum and the rescaled context, two
[B, 1] all-reduces and one [B, D] all-reduce, whatever L is.
"""

from __future__ import annotations

import torch

from ..parallel.distributed import all_reduce
from . import attention_step as as_ops


def make_sharded_attention_step(mesh, use_kernel: bool = True):
    """Returns ``step(keys, query, v, memory, mask) -> (context [B, D] f32,
    alignments [B, L/M] f32)``: the context is the same on every rank of the
    row, the alignments are this rank's slice.  ``use_kernel`` runs the
    per-shard half through :func:`attention_step_partial` (the CUDA kernel
    for CUDA tensors, its plain version for CPU tensors); ``False`` runs the
    plain version everywhere (``parallel.use_pallas_seq_attention=false``)."""
    partial = (as_ops.attention_step_partial if use_kernel
               else as_ops.attention_step_partial_reference)
    group = mesh.model_group

    def step(keys, query, v, memory, mask):
        ctx_u, p_u, m_loc, s_loc = partial(keys, query, v, memory, mask)
        # the combine, in the JAX package's order
        m = all_reduce(m_loc, "max", group)
        scale = torch.exp(m_loc - m)                                  # [B, 1]
        denom = torch.clamp(all_reduce(s_loc * scale, "sum", group), min=1e-9)
        p = p_u * (scale / denom)
        ctx = all_reduce(ctx_u * (scale / denom), "sum", group)
        return ctx, p

    return step
