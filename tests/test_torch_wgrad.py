"""The weight-gradient reduction's route and launch plan (``ops/wgrad.py``),
as pure functions of the factors' shapes, strides, dtypes and alignment.

The route rule and the plan decide, before any launch, which kernel of
``csrc/wgrad.cu`` runs, its output tiles and its row ranges; the card
tests (``tests/test_torch_gpu.py``) hold the kernels' sums against
``wgrad_reference`` over one, the plan's and many row ranges.
"""

import pytest
import torch

from tacotron_multispeaker_torch.ops import wgrad as twg


def _teacher(S=200, B=32, H=256, A=256, D=320, N=2):
    """The teacher backward's 11 products, laid out as its kernels write the
    factors (every one f32; column slices of the ``dgc`` stream)."""
    from tacotron_multispeaker_torch.ops import teacher_decoder as ttd
    z = lambda *s: torch.zeros(*s)
    streams = (z(S, B, H), z(S, B, 4 * H), z(S, B, D), z(S, B, A), z(N, S, B, H),
               z(N, S, B, H), z(N, S, B, 3 * H))
    return ttd._weight_grad_problems(z(S, B, H), z(S, B, H), tuple(z(S, B, H) for _ in range(N)),
                                     (z(S, B, 2 * H), z(S, B, H)), streams)


def _bigru(T=1000, B=32, F=128, dtype=torch.bfloat16):
    hprev, dxg = torch.zeros(T, 2, B, F, dtype=dtype), torch.zeros(T, 2, B, 2 * F)
    rh, dxc = torch.zeros(T, 2, B, F, dtype=dtype), torch.zeros(T, 2, B, F)
    return ([(hprev[:, d], dxg[:, d], False) for d in range(2)]
            + [(rh[:, d], dxc[:, d], False) for d in range(2)])


def _gru(T=1000, B=32, F=128, dtype=torch.bfloat16):
    return [(torch.zeros(T, B, F, dtype=dtype), torch.zeros(T, B, 2 * F), False),
            (torch.zeros(T, B, F, dtype=dtype), torch.zeros(T, B, F), False)]


def _ragged():
    # K = 40 and 264, N = 72 and 8, rows 35 and 33, mixed dtypes, a bias
    a = torch.zeros(7, 5, 40)
    g = torch.zeros(7, 5, 72)
    return [(a, g, True), (torch.zeros(3, 11, 264, dtype=torch.bfloat16), torch.zeros(3, 11, 8),
                           True)]


MAIN_PATH = {"teacher": _teacher, "bigru": _bigru, "gru": _gru}


@pytest.mark.parametrize("kind", list(MAIN_PATH))
def test_wgrad_main_path_launches_take_the_tensor_cores_in_bf16(kind):
    problems = MAIN_PATH[kind]()
    assert twg.route(problems, torch.bfloat16) == "mma"
    assert twg.route(problems, torch.float32) == "fma"
    p = twg.plan(problems, torch.bfloat16, n_sm=132)
    assert (p.route, p.tile) == ("mma", 128)
    # the first wave of blocks (one an SM) fills at least 90 % of 132 SMs
    assert min(sum(tk * tn for tk, tn in p.tiles) * p.splits, 132) >= 0.9 * 132


def _misaligned(kind):
    """One bf16 problem whose factors break the 16-byte rule in one way."""
    a = torch.zeros(40, 3, 136, dtype=torch.bfloat16)
    g = torch.zeros(40, 3, 64)
    if kind == "address":            # rows start 2 bytes into a 16-byte vector
        return [(a[..., 1:129], g, False)]
    if kind == "width":              # 20 bf16 columns: 40 bytes
        return [(a[..., :20], g, False)]
    if kind == "row stride":         # rows 264 bytes apart
        return [(torch.zeros(40, 3, 132, dtype=torch.bfloat16)[..., :128], g, False)]
    return [(a[..., :128], g[..., :62], False)]      # G 248 bytes wide


@pytest.mark.parametrize("kind", ["address", "width", "row stride", "g width"])
def test_wgrad_misaligned_bf16_factors_take_the_fma_route(kind):
    problems = _misaligned(kind)
    assert twg.route(problems, torch.bfloat16) == "fma"
    assert twg.plan(problems, torch.bfloat16).route == "fma"


def test_wgrad_aligned_views_keep_the_tensor_core_route():
    # a direction of [T, 2, B, F] and a 16-byte-aligned column slice
    a = torch.zeros(40, 2, 3, 136, dtype=torch.bfloat16)
    g = torch.zeros(40, 2, 3, 72)
    problems = [(a[:, 1, :, 8:136], g[:, 0, :, 4:68], True)]
    assert twg.route(problems, torch.bfloat16) == "mma"
    assert twg.route(problems, torch.float32) == "fma"
    assert twg.plan(problems, torch.bfloat16).route == "mma"
    assert twg.plan(problems, torch.bfloat16, fma=True).route == "fma"


CASES = {**{k: f for k, f in MAIN_PATH.items()}, "ragged": _ragged,
         "bigru f32": lambda: _bigru(T=37, B=3, F=32, dtype=torch.float32)}


@pytest.mark.parametrize("splits", [None, 1, 3])
@pytest.mark.parametrize("cdt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", list(CASES))
def test_wgrad_plan_tiles_cover_each_problem(case, cdt, splits):
    problems = CASES[case]()
    p = twg.plan(problems, cdt, n_sm=132, splits=splits)
    assert p.route == twg.route(problems, cdt)
    assert p.tile == (128 if p.route == "mma" else 64)
    # the given row ranges, else between one and a range a _MIN_ROWS rows
    rows = min(a.shape[0] * a.shape[1] for a, _, _ in problems)
    assert p.splits == splits if splits else 1 <= p.splits <= max(1, rows // 256)
    # each problem's tiles cover its K and N, none past them
    assert len(p.tiles) == len(problems)
    for (tk, tn), (a, g, _) in zip(p.tiles, problems):
        assert (tk - 1) * p.tile < a.shape[-1] <= tk * p.tile
        assert (tn - 1) * p.tile < g.shape[-1] <= tn * p.tile


def test_wgrad_plan_splits_balance_waves_and_partials():
    # one block an SM (132): the teacher's 92 tiles in 4 ranges (368
    # blocks, 3 waves of 1600 rows) rather than 2 (2 waves of 3200 rows);
    # the BiGRU's 6 tiles in 22 ranges (one wave), the GRU's 3 in 42 (one wave)
    assert twg.plan(_teacher(), torch.bfloat16, n_sm=132).splits == 4
    assert twg.plan(_bigru(), torch.bfloat16, n_sm=132).splits == 22
    assert twg.plan(_gru(), torch.bfloat16, n_sm=132).splits == 42
    # few rows: one range of at least _MIN_ROWS
    assert twg.plan(_ragged(), torch.bfloat16, n_sm=132).splits == 1
    with pytest.raises(ValueError, match="row ranges"):
        twg.plan(_gru(), torch.bfloat16, splits=0)


def test_wgrad_tensor_core_block_fits_shared_memory():
    # csrc/wgrad.cu TC_SMEM; the card test holds the two equal
    assert twg.tc_smem_bytes() <= 232448
