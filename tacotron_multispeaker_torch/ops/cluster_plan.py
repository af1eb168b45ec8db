"""The cluster size of the kernels that run one batch row on a thread-block
cluster of C CTAs (``csrc/decoder_loop.cu``, ``csrc/teacher_decoder_fwd.cu``,
``csrc/attention_step.cu``; helpers in ``csrc/cluster_common.cuh``)."""

from __future__ import annotations

CLUSTER_SIZES = (16, 8, 4, 2, 1)


def launch_plan(B: int, H: int, vec: int, clusters: dict) -> int:
    """The cluster size C for a batch of B rows: the largest of 16, 8, 4, 2
    that leaves every CTA some of the H hidden units (C <= H / vec) and of
    which the card holds all B clusters at once (``clusters[C]``, its
    co-resident count), else 1 (one CTA a row; the rows then run in waves)."""
    for C in CLUSTER_SIZES[:-1]:
        if C <= H // vec and clusters.get(C, 0) >= B:
            return C
    return 1


# the attention step's plan, from the sweeps over C on an H100 (PERF.md
# §6): tools/attention_plan_sweep.py at L = 8, 13, 16, 24, 32, 40, 48 and
# B = 1, 3, 8, 32 (kernels 9 and 10), chip_smoke.py's attention phases at
# L = 96 and 192.  One CTA was the fastest for every row of 16 positions
# or fewer, a cluster from 24 on; there this rule's C was within 5 % of the
# fastest at every shape timed.  C = 16 was the fastest for one row and
# slower than 8 for 8 and 32 rows
ATTENTION_MIN_LENGTH = 24
ATTENTION_MIN_POSITIONS = 5
ATTENTION_MAX_ROWS_AT_16 = 2


def attention_plan(B: int, L: int, clusters: dict) -> int:
    """The cluster size C of the attention step (``csrc/attention_step.cu``,
    one batch row of L positions split along L over C CTAs) for a batch of
    B rows: for rows of at least ATTENTION_MIN_LENGTH positions, the
    largest of 16, 8, 4, 2 that leaves every CTA at least
    ATTENTION_MIN_POSITIONS positions and of which the card holds all B
    clusters at once (``clusters[C]``, its co-resident count), 16 only for
    B <= ATTENTION_MAX_ROWS_AT_16; else the smallest size the card takes at
    all (1 where its shared memory allows; the rows then run in waves).
    Every CTA gets at least one position (C <= L).  Raises ValueError where
    the card takes none."""
    for C in CLUSTER_SIZES[:-1]:
        if (L >= max(ATTENTION_MIN_LENGTH, ATTENTION_MIN_POSITIONS * C)
                and clusters.get(C, 0) >= B
                and (C < 16 or B <= ATTENTION_MAX_ROWS_AT_16)):
            return C
    for C in reversed(CLUSTER_SIZES):
        if C <= L and clusters.get(C, 0) > 0:
            return C
    raise ValueError(f"attention step: the card holds no cluster for L={L} "
                     f"(co-resident clusters {clusters})")
