"""The cluster size of the kernels that run one batch row on a thread-block
cluster of C CTAs (``csrc/decoder_loop.cu``, ``csrc/teacher_decoder_fwd.cu``;
helpers in ``csrc/cluster_common.cuh``)."""

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
