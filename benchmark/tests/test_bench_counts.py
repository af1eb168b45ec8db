"""The frozen bound arithmetic against the port's kernel table (PERF.md,
"Bound ms"), and the model FLOPs against a hand count."""

import dataclasses

import pytest

from benchmark import counts
from tacotron_multispeaker_torch.config import get_config

VCTK = dataclasses.asdict(get_config("multispeaker_vctk"))


@pytest.mark.parametrize("fn,args,ms", [
    (counts.decoder_loop_bound_s, (32, 192, 200), 0.0369),
    (counts.teacher_fwd_bound_s, (32, 192, 200), 0.0336),
    (counts.teacher_bwd_bound_s, (32, 192, 200), 0.0695),
])
def test_kernel_bounds(fn, args, ms):
    assert fn(*args, VCTK) * 1e3 == pytest.approx(ms, abs=5e-5)


def test_gl_iteration_bound():
    assert counts.gl_iteration_bound_s(32, 1000, VCTK, 12) * 1e3 == pytest.approx(3.359,
                                                                                     abs=5e-4)


def test_model_flops_hand_count_tiny():
    d = dataclasses.asdict(get_config("tiny", "model.num_speakers=4"))
    # tiny with 4 speakers: embedding 64 + speaker 64, prenet 64/32, encoder
    # CBHG K=8 C=32, projections (32, 32), 2 highways of 32, GRU 32 a way;
    # memory 64 + 64 = 128, A=64, H=64, N=2, r=5, M=80; post-net K=4 C=32,
    # projections (64, 80), highway_in 80 → 32, 2 highways, GRU 32; 513 bins
    gru = lambda x, f: 2 * x * 3 * f + 2 * f * 3 * f
    L, S = 7, 3
    enc_char = (2 * 128 * 64 + 2 * 64 * 32 + sum(2 * k * 32 * 32 for k in range(1, 9))
                + 2 * 3 * 256 * 32 + 2 * 3 * 32 * 32 + 2 * (2 * 32 * 32 * 2)
                + 2 * gru(32, 32) + 2 * 128 * 64)
    step = (2 * 80 * 64 + 2 * 64 * 32 + gru(32 + 128, 64) + 2 * 64 * 64 + 2 * L * 64
            + 2 * L * 128 + 2 * (64 + 128) * 64 + 2 * gru(64, 64) + 2 * 64 * 400)
    post_frame = (sum(2 * k * 80 * 32 for k in range(1, 5)) + 2 * 3 * 128 * 64
                  + 2 * 3 * 64 * 80 + 2 * 80 * 32 + 2 * (2 * 32 * 32 * 2) + 2 * gru(32, 32)
                  + 2 * 64 * 513)
    init = 2 * 64 * 3 * 64
    want = L * enc_char + init + S * step + S * 5 * post_frame
    assert counts.forward_flops(d, L, S) == want
    assert counts.train_flops(d, [L], [S * 5]) == 3 * want
