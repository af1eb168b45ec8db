"""Attention mechanisms: Bahdanau (content) and location-sensitive.

Port of ``tacotron_multispeaker_tpu/models/attention.py``.  ``precompute_keys``
projects the encoder memory once per utterance.  ``forward`` is one decoder
step of the per-step decode: (query, keys, memory, mask, state) → (context,
alignments, state), the state carrying the previous and the cumulative
alignments.  With ``use_pallas`` (the JAX package's switch) the energies,
softmax and context of a step run in the attention-step kernel
(ops/attention_step.py); otherwise in the plain module math.  The fused
decoder loop (ops/decoder_loop.py) runs Bahdanau's step inside its own
kernel.  With ``seq_mesh`` (the sequence-sharded decode of
``Synthesizer.make_sharded_synth``) Bahdanau's keys, memory and mask are
this rank's slice of the encoder length, and the step is the distributed
softmax of ops/sharded_attention.py, in f32, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import attention_step as as_ops
from ..ops.sharded_attention import make_sharded_attention_step
from .modules import Dense


class AttentionState(NamedTuple):
    alignments: torch.Tensor       # [B, L] previous alignments, f32
    accumulated: torch.Tensor      # [B, L] cumulative alignments, f32


def masked_softmax(energies: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis with masked positions filled with −1e9,
    zeroed after the exp, and the sum floored at 1e-9."""
    energies = torch.where(mask, energies, torch.full_like(energies, -1e9))
    m = energies.max(dim=-1, keepdim=True).values
    e = torch.exp(energies - m) * mask
    return e / torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-9)


def init_state(batch: int, length: int, device) -> AttentionState:
    z = torch.zeros((batch, length), dtype=torch.float32, device=device)
    return AttentionState(z, z)


class BahdanauAttention(nn.Module):
    """Additive content attention: score = v·tanh(W_q q + W_k m).

    ``seq_mesh``: keys, memory and mask hold this rank's slice of L, and a
    step runs the sharded distributed softmax, its per-shard half in kernel
    10 unless ``seq_kernel`` is off (``parallel.use_pallas_seq_attention``)."""

    def __init__(self, units: int, query_depth: int, memory_depth: int,
                 dtype: torch.dtype = torch.float32, use_pallas: bool = False,
                 seq_mesh=None, seq_kernel: bool = True):
        super().__init__()
        self.use_pallas = use_pallas
        self.seq_step = (None if seq_mesh is None
                         else make_sharded_attention_step(seq_mesh, use_kernel=seq_kernel))
        self.query = Dense(query_depth, units, bias=False, dtype=dtype)
        self.memory = Dense(memory_depth, units, bias=False, dtype=dtype)
        self.v = nn.Parameter(torch.empty(units))

    def precompute_keys(self, memory: torch.Tensor) -> torch.Tensor:
        """[B, L, D] -> [B, L, A], once per utterance."""
        return self.memory(memory)

    def _location_term(self, state: AttentionState, keys: torch.Tensor):
        return None

    def forward(self, query: torch.Tensor, keys: torch.Tensor, memory: torch.Tensor,
                mask: torch.Tensor, state: AttentionState | None = None):
        """One decoder step: query [B, Q] -> (context [B, D] in memory's
        dtype, alignments [B, L] f32, the next state)."""
        if state is None:
            state = init_state(keys.shape[0], keys.shape[1], keys.device)
        q = self.query(query)
        loc = self._location_term(state, keys)
        v = self.v.to(keys.dtype)
        if self.seq_step is not None:
            # f32 in and out of the sharded step, as the JAX attention.py:94-98 does
            context, align = self.seq_step(keys.float(), q.float(), self.v.float(),
                                           memory.float(), mask)
            context = context.to(memory.dtype)
        elif self.use_pallas:
            # the location-sensitive score bias shifts every energy alike and
            # the softmax ignores it, so the kernel leaves it out (as in JAX)
            context, align = as_ops.attention_step(keys.contiguous(), q.contiguous(), v,
                                                   memory.contiguous(), mask, loc)
            context = context.to(memory.dtype)
        else:
            act = q[:, None, :] + keys
            if loc is not None:
                act = act + loc
            e = (torch.tanh(act) @ v).float()
            if loc is not None:
                e = e + self.b
            align = masked_softmax(e, mask)
            context = torch.einsum("bl,bld->bd", align.to(memory.dtype), memory)
        return context, align, AttentionState(align, state.accumulated + align)


class LocationSensitiveAttention(BahdanauAttention):
    """Content + location attention (Chorowski et al.): the energies also
    see ``loc_proj(loc_conv(cumulative alignments))``; the width-31 location
    conv (1 → filters channels, SAME, no bias) and its projection run in
    plain PyTorch in the compute dtype, outside the kernel, as in JAX."""

    def __init__(self, units: int, query_depth: int, memory_depth: int,
                 filters: int = 32, kernel: int = 31,
                 dtype: torch.dtype = torch.float32, use_pallas: bool = False):
        super().__init__(units, query_depth, memory_depth, dtype, use_pallas)
        self.compute_dtype = dtype
        self.loc_conv = nn.Conv1d(1, filters, kernel, bias=False)
        self.loc_proj = Dense(filters, units, bias=False, dtype=dtype)
        self.b = nn.Parameter(torch.zeros(()))

    def _location_term(self, state: AttentionState, keys: torch.Tensor) -> torch.Tensor:
        """[B, L, A] in the compute dtype."""
        dt = self.compute_dtype
        width = self.loc_conv.kernel_size[0]
        acc = F.pad(state.accumulated.to(dt)[:, None, :], ((width - 1) // 2, width // 2))
        loc = F.conv1d(acc, self.loc_conv.weight.to(dt)).transpose(1, 2)   # [B, L, F]
        return self.loc_proj(loc)


def make_attention(model_cfg, memory_depth: int, dtype: torch.dtype = torch.float32,
                   use_pallas: bool = False, seq_mesh=None,
                   seq_kernel: bool = True) -> nn.Module:
    m = model_cfg
    if m.attention_type == "bahdanau":
        return BahdanauAttention(m.attention_depth, m.decoder_depth, memory_depth, dtype,
                                 use_pallas, seq_mesh, seq_kernel)
    if m.attention_type == "location":
        if seq_mesh is not None:
            raise NotImplementedError(
                "sequence-sharded decode supports bahdanau attention only "
                "(location conv over the cumulative alignments would need a "
                "halo exchange)")
        return LocationSensitiveAttention(
            m.attention_depth, m.decoder_depth, memory_depth,
            m.attention_location_filters, m.attention_location_kernel, dtype, use_pallas)
    raise ValueError(f"unknown attention_type {m.attention_type!r}")
