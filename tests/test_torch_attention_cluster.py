"""The attention step's cluster kernel (``csrc/attention_step.cu``, kernels 9
and 10) where the CPU can hold it: its cluster plan, its shared-memory
mirror and limits, and its combine over the cluster.

The kernel splits a batch row's L positions over a cluster of C CTAs and
merges each CTA's (m_k, s_k) (a butterfly over the ranks) and context
partial (in rank order).
``attention_step_split_reference`` and
``attention_step_partial_split_reference`` render that combine in plain
PyTorch; here they are held against the JAX package's Pallas kernels in
interpret mode for every C, ragged chunks and fully masked chunks and rows,
so that a wrong merge shows before the card runs it.  The kernel itself
against these on the card is in ``test_torch_gpu.py``.
"""

import functools

import numpy as np
import pytest
import torch

from tacotron_multispeaker_torch.device import warm_cpu_math
from tacotron_multispeaker_torch.ops import attention_step as tas
from tacotron_multispeaker_torch.ops.cluster_plan import (ATTENTION_MAX_ROWS_AT_16,
                                                          ATTENTION_MIN_LENGTH,
                                                          ATTENTION_MIN_POSITIONS,
                                                          CLUSTER_SIZES, attention_plan)


@pytest.fixture(scope="module", autouse=True)
def _cpu_math_ready():
    # the comparisons below hold f32 tanh/exp to 1e-6: see device.warm_cpu_math
    warm_cpu_math()


# -- the plan ------------------------------------------------------------------

# co-resident clusters an H100 reported for kernel 9 at L=192 bf16 with the
# location term (16: the card holds fewer than 32 rows), and sets that rule
# sizes out
COUNTS = {
    "h100": {16: 28, 8: 62, 4: 62, 2: 66, 1: 660},
    "no_16_or_8": {16: 0, 8: 0, 4: 40, 2: 66, 1: 132},
    "few": {16: 2, 8: 4, 4: 8, 2: 16, 1: 132},
    "only_1": {16: 0, 8: 0, 4: 0, 2: 0, 1: 132},
    "no_1": {16: 7, 8: 15, 4: 30, 2: 66, 1: 0},
}


def _fits(C, B, L, counts):
    return (L >= ATTENTION_MIN_LENGTH and L >= ATTENTION_MIN_POSITIONS * C and counts[C] >= B
            and (C < 16 or B <= ATTENTION_MAX_ROWS_AT_16))


@pytest.mark.parametrize("counts", sorted(COUNTS))
@pytest.mark.parametrize("L", [1, 13, 24, 40, 48, 96, 192])
@pytest.mark.parametrize("B", [1, 3, 8, 32])
def test_attention_plan_picks_the_largest_fitting_cluster(B, L, counts):
    c = COUNTS[counts]
    taken = [s for s in CLUSTER_SIZES if s <= L and c[s] > 0]
    if not taken:                            # L=1 where the card holds no C=1
        with pytest.raises(ValueError, match="no cluster"):
            attention_plan(B, L, c)
        return
    C = attention_plan(B, L, c)
    # a size the card takes, every CTA at least one position
    assert C in taken
    larger = [s for s in CLUSTER_SIZES[:-1] if _fits(s, B, L, c)]
    if larger:
        assert C == max(larger)
    elif c[1] > 0:
        assert C == 1                        # nothing larger fits
    else:                                    # the smallest size the card takes
        assert C == min(taken)


@pytest.mark.parametrize("B,L,counts,want", [
    (1, 96, "h100", 16),      # a serving request: 6 positions a CTA
    (1, 80, "h100", 16),      # 5 positions a CTA
    (1, 79, "h100", 8),
    (1, 192, "h100", 16),
    (32, 192, "h100", 8),     # 16 is not co-resident for 32 rows; 8 is
    (8, 192, "h100", 8),      # 16 only for one or two rows
    (8, 48, "h100", 8),       # kernel 10's shard of shard_seq
    (3, 13, "h100", 1),       # shorter than ATTENTION_MIN_LENGTH: one CTA
    (8, 23, "h100", 1),
    (8, 24, "h100", 4),       # the shortest row split, 5 positions a CTA at least
    (8, 40, "h100", 8),
    (1, 5, "h100", 1),
    (32, 192, "few", 1),      # no size holds 32 rows at once: one CTA a row
    (32, 192, "no_1", 2),     # C = 1 does not fit: the smallest that does
])
def test_attention_plan_cases(B, L, counts, want):
    assert attention_plan(B, L, COUNTS[counts]) == want


def test_attention_plan_raises_when_the_card_takes_nothing():
    with pytest.raises(ValueError, match="no cluster"):
        attention_plan(1, 96, {C: 0 for C in CLUSTER_SIZES})
    with pytest.raises(ValueError, match="no cluster"):       # only C > L fits
        attention_plan(1, 1, {16: 7, 8: 15, 4: 30, 2: 66, 1: 0})


# -- shared memory and limits ----------------------------------------------------

def test_direct_route_at_one_cta_takes_every_shape_the_first_design_took():
    # the first design: (2A + L) floats of dynamic shared memory and 8 static
    # ones; the direct route at C = 1 takes the (2A + L) (shapes at that
    # limit)
    for A, L in ((8, 1), (256, 192), (8, 58088), (100, 57904), (1000, 56104)):
        first = (2 * A + L) * 4 + 32
        assert first <= 232448
        assert tas.smem_bytes(L, A, 7, 1, 2, True, False) == first - 32
        assert tas.kernel_takes(L, A, 7, 2, True)
    # past it a larger C still fits: the energies of ceil(L/C) positions
    assert tas.kernel_takes(60000, 8, 4, 4, False)
    assert not tas.smem_bytes(60000, 8, 4, 1, 4, False, False) <= 232448


def test_kernel_limit_is_where_even_sixteen_ctas_do_not_fit():
    A, D = 8, 4
    # at C = 16: the exchanges' two mbarriers (4 floats), 2A + ceil(L/16) +
    # 32 + 16 * ceil(D/16) floats
    fixed = 4 + 2 * A + 2 * 16 + 16
    last = 16 * (232448 // 4 - fixed)
    assert tas.smem_bytes(last, A, D, 16, 4, False, False) == 232448
    assert tas.kernel_takes(last, A, D, 4, False)
    assert not tas.kernel_takes(last + 1, A, D, 4, False)


@pytest.mark.parametrize("A,D,esize,aligned", [
    (256, 320, 2, True), (256, 384, 4, True), (100, 72, 2, False), (256, 72, 2, True),
    (64, 36, 4, True), (64, 34, 4, False), (6, 8, 4, False)])
def test_rows_aligned(A, D, esize, aligned):
    assert tas.rows_aligned(A, D, esize) == aligned


def test_staged_route_needs_aligned_rows_and_a_fitting_slab():
    # kernel 9's B=32 shape: one CTA's slabs (192 positions, 832 bf16 a
    # position) do not fit; two CTAs' halves do
    assert not tas.staged_route(192, 256, 320, 1, 2, True, True)
    assert tas.staged_route(192, 256, 320, 2, 2, True, True)
    assert not tas.staged_route(192, 256, 320, 2, 2, True, False)    # unaligned
    assert tas.smem_bytes(192, 256, 320, 2, 2, True, True) > tas.smem_bytes(
        192, 256, 320, 2, 2, True, False)


# -- the combine against the JAX package ------------------------------------------

def _case(L, seed=7, B=5, A=24, D=10):
    """keys, q, v, memory, mask, location term (f32 numpy): row 0 full, row
    1 fully masked, row 2 two positions (later chunks fully masked), row 3
    a random mask with holes, row 4 ending inside the last chunk."""
    rs = np.random.RandomState(seed + L)
    f = lambda *s, sc=1.0: (rs.randn(*s) * sc).astype(np.float32)  # noqa: E731
    mask = np.zeros((B, L), bool)
    mask[0] = True
    mask[2, :2] = True
    mask[3] = rs.rand(L) < 0.5
    mask[3, 0] = True
    mask[4, :max(1, L - 3)] = True
    return (f(B, L, A, sc=0.5), f(B, A, sc=0.5), f(A, sc=A ** -0.5), f(B, L, D), mask,
            f(B, L, A, sc=0.3))


@functools.lru_cache(maxsize=None)
def _jax_step(L, loc):
    pytest.importorskip("flax")
    import jax.numpy as jnp
    from tacotron_multispeaker_tpu.ops.attention_step import attention_step_pallas
    keys, q, v, mem, mask, lt = _case(L)
    out = attention_step_pallas(jnp.asarray(keys), jnp.asarray(q), jnp.asarray(v),
                                jnp.asarray(mem), jnp.asarray(mask),
                                jnp.asarray(lt) if loc else None, interpret=True)
    return tuple(np.asarray(o) for o in out)


@functools.lru_cache(maxsize=None)
def _jax_partial(L):
    pytest.importorskip("flax")
    import jax.numpy as jnp
    from tacotron_multispeaker_tpu.ops.attention_step import attention_step_partial
    keys, q, v, mem, mask, _ = _case(L)
    out = attention_step_partial(jnp.asarray(keys), jnp.asarray(q), jnp.asarray(v),
                                 jnp.asarray(mem), jnp.asarray(mask), interpret=True)
    return tuple(np.asarray(o) for o in out)


# L not divisible by C (13, 97) and one position a CTA (16 at C = 16)
SPLITS = [(L, C) for L in (13, 16, 97) for C in (1, 2, 4, 8, 16) if C <= L]


@pytest.mark.parametrize("loc", [False, True])
@pytest.mark.parametrize("L,C", SPLITS)
def test_split_combine_matches_jax_attention_step(L, C, loc):
    keys, q, v, mem, mask, lt = (torch.from_numpy(a) for a in _case(L))
    ctx, al = tas.attention_step_split_reference(keys, q, v, mem, mask,
                                                 lt if loc else None, C=C)
    ctx_j, al_j = _jax_step(L, loc)
    # f32: the same arithmetic; s and the context are summed in another
    # order (per chunk, then over chunks)
    np.testing.assert_allclose(al.numpy(), al_j, atol=1e-6)
    np.testing.assert_allclose(ctx.numpy(), ctx_j, atol=1e-5)
    assert torch.all(al[~mask] == 0.0)
    assert torch.all(al[1] == 0.0) and torch.all(ctx[1] == 0.0)      # fully masked row


@pytest.mark.parametrize("L,C", SPLITS)
def test_split_combine_matches_jax_attention_step_partial(L, C):
    keys, q, v, mem, mask, _ = (torch.from_numpy(a) for a in _case(L))
    ctx, p, m, s = tas.attention_step_partial_split_reference(keys, q, v, mem, mask, C=C)
    ctx_j, p_j, m_j, s_j = _jax_partial(L)
    np.testing.assert_allclose(p.numpy(), p_j, atol=1e-6)
    np.testing.assert_allclose(m.numpy(), m_j, atol=1e-6, rtol=0)
    np.testing.assert_allclose(s.numpy(), s_j, atol=1e-5)
    np.testing.assert_allclose(ctx.numpy(), ctx_j, atol=1e-5)
    # the fully masked row, bit-exact: the combine across shards relies on it
    assert m[1].item() == -1e9 and s[1].item() == 0.0
    assert torch.all(p[1] == 0.0) and torch.all(ctx[1] == 0.0)


@pytest.mark.parametrize("C", [2, 4, 8, 16])
def test_split_combine_of_one_chunk_is_the_plain_version(C):
    # C = 1 is the plain version itself; at every C the merged (m, s) of a
    # row differs from the plain one by rounding only
    keys, q, v, mem, mask, lt = (torch.from_numpy(a) for a in _case(97))
    one = tas.attention_step_partial_split_reference(keys, q, v, mem, mask, C=1)
    plain = tas.attention_step_partial_reference(keys, q, v, mem, mask)
    for a, b in zip(one, plain):
        assert torch.equal(a, b)
    split = tas.attention_step_partial_split_reference(keys, q, v, mem, mask, C=C)
    assert torch.equal(split[2], plain[2])                          # max: exact
    np.testing.assert_allclose(split[3].numpy(), plain[3].numpy(), rtol=1e-6)
