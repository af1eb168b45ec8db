"""``AudioProcessor.find_endpoints`` (a batch, on its device) against
``AudioProcessor.find_endpoint`` (one host row), row by row, on the CPU; on
a card the same on the card's tensors against the CPU's answer (``gpu``
marker; it skips without a CUDA device)."""

import numpy as np
import pytest
import torch

from tacotron_multispeaker_torch.audio import AudioProcessor
from tacotron_multispeaker_torch.config import AudioConfig

RATES = [22050, 20000]


def processor(sr, min_silence_sec=0.8):
    """→ (the AudioProcessor, its window in samples, its f32 threshold)."""
    ap = AudioProcessor(AudioConfig(sample_rate=sr, min_silence_sec=min_silence_sec),
                        device="cpu")
    window = int(sr * min_silence_sec)
    thr = float(np.float32(10.0 ** (ap.cfg.silence_threshold_db * 0.05)))
    assert ap.silence() == (window, thr)
    return ap, window, thr


def loud(rs, n, thr):
    """Every sample well above the threshold, either sign."""
    return (rs.uniform(5, 50, n) * thr * rs.choice([-1, 1], n)).astype(np.float32)


def quiet(rs, n, thr):
    return (rs.uniform(-0.5, 0.5, n) * thr).astype(np.float32)


def row_case(name, sr, min_silence_sec=0.8):
    """→ (wav [1, N] f32, the endpoint it must give or None) for one case."""
    if name == "loud_last_sample_of_window":
        # 0.3 s: 6615 samples at 22.05 kHz, three past the window's four hops
        min_silence_sec = 0.3
    ap, window, thr = processor(sr, min_silence_sec)
    hop = window // 4
    rs = np.random.RandomState(sr + len(name))
    N = 12 * window + 123

    def silent_from(s0):
        w = loud(rs, N, thr)
        w[s0:] = quiet(rs, N - s0, thr)
        return w

    last = max(range(hop, N - window, hop))                 # the last window start
    if name == "silence_at_boundary":
        w, want = silent_from(5 * hop), 6 * hop
    elif name == "silence_one_hop_later":
        w, want = silent_from(6 * hop), 7 * hop
    elif name == "silence_one_sample_late":
        w, want = silent_from(5 * hop + 1), 7 * hop
    elif name == "last_window_silent":
        w, want = silent_from(last), last + hop
    elif name == "loud_sample_in_last_window":
        w, want = silent_from(last), N
        w[last + window - 1] = 2 * thr
    elif name == "loud_last_sample_of_window":
        # the windows from 5·hop to 9·hop hold it, the one at 10·hop does not
        w, want = silent_from(5 * hop), (10 if window % 4 == 0 else 11) * hop
        w[5 * hop + window - 1] = 2 * thr
    elif name == "sample_at_threshold":
        w, want = silent_from(5 * hop), 7 * hop
        w[5 * hop + hop // 2] = -thr                        # not below: not silence
    elif name == "sample_just_below_threshold":
        w, want = silent_from(5 * hop), 6 * hop
        w[5 * hop + hop // 2] = np.nextafter(np.float32(thr), np.float32(0))
    elif name == "nan_in_silence":
        w, want = silent_from(5 * hop), 7 * hop
        w[5 * hop + 7] = np.nan
    elif name == "all_silent":
        w, want = quiet(rs, N, thr), 2 * hop
    elif name == "zeros":
        w, want = np.zeros(N, np.float32), 2 * hop
    elif name == "never_silent":
        w, want = loud(rs, N, thr), N
    elif name == "shorter_than_window_and_hop":
        w, want = np.zeros(window + hop - 1, np.float32), window + hop - 1
    elif name == "exactly_window_and_hop":
        w, want = np.zeros(window + hop, np.float32), window + hop
    elif name == "one_window_start":
        w, want = np.zeros(window + hop + 1, np.float32), 2 * hop
    else:
        raise ValueError(name)
    return w[None], want, ap, window, thr


CASES = ["silence_at_boundary", "silence_one_hop_later", "silence_one_sample_late",
         "last_window_silent", "loud_sample_in_last_window", "loud_last_sample_of_window",
         "sample_at_threshold",
         "sample_just_below_threshold", "nan_in_silence", "all_silent", "zeros",
         "never_silent", "shorter_than_window_and_hop", "exactly_window_and_hop",
         "one_window_start"]


def batch_case(sr, B, min_silence_sec=0.8):
    """B rows of random loud and quiet stretches, some with a spike in the
    silence, some never silent, some all silent."""
    ap, window, thr = processor(sr, min_silence_sec)
    rs = np.random.RandomState(B + sr)
    N = 9 * window + 77
    wav = loud(rs, B * N, thr).reshape(B, N)
    for i in range(B):
        s0 = int(rs.randint(0, N + window))
        wav[i, s0:] = quiet(rs, max(N - s0, 0), thr)
        for _ in range(int(rs.randint(0, 3))):
            wav[i, rs.randint(0, N)] = rs.choice([thr, -thr, 3 * thr])
    return wav, ap, window, thr


def host_endpoints(ap, wav):
    return [ap.find_endpoint(row) for row in wav]


@pytest.mark.parametrize("sr", RATES)
@pytest.mark.parametrize("case", CASES + ["batch_1", "batch_32", "window_not_by_4"])
def test_find_endpoints_is_find_endpoint_row_by_row(case, sr):
    want = None
    if case.startswith("batch_"):
        wav, ap, window, thr = batch_case(sr, int(case.split("_")[1]))
    elif case == "window_not_by_4":
        # 0.3 s: 6615 samples at 22.05 kHz, 6000 at 20 kHz; the first has
        # 3 samples past its four hops
        wav, ap, window, thr = batch_case(sr, 8, min_silence_sec=0.3)
    else:
        wav, want, ap, window, thr = row_case(case, sr)
    got = ap.find_endpoints(torch.from_numpy(wav))
    assert got.dtype == torch.int64 and got.shape == (len(wav),)
    assert got.tolist() == host_endpoints(ap, wav)
    if want is not None:
        assert got.tolist() == [want]
    if case == "batch_32":                 # the batch holds cut and uncut rows
        assert 0 < int((got < wav.shape[1]).sum()) < 32


def test_find_endpoints_refuses_what_it_cannot_run():
    ap = processor(22050)[0]
    with pytest.raises(ValueError, match="float32"):
        ap.find_endpoints(torch.zeros(2, 100, dtype=torch.float64))
    with pytest.raises(ValueError, match="float32"):
        ap.find_endpoints(torch.zeros(100))
    with pytest.raises(ValueError, match="no hop"):
        AudioProcessor(AudioConfig(sample_rate=30, min_silence_sec=0.1),
                       device="cpu").find_endpoints(torch.zeros(2, 100))
    assert ap.find_endpoints(torch.zeros(0, 100)).shape == (0,)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: python -m pytest -m gpu tests/test_torch_*.py")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("sr", RATES)
def test_card_matches_cpu(cuda, sr):
    cases = [(wav, ap) for wav, _, ap, _, _ in map(lambda c: row_case(c, sr), CASES)]
    cases += [(wav, ap) for wav, ap, _, _ in (
        batch_case(sr, 1), batch_case(sr, 32), batch_case(sr, 8, 0.3))]
    for wav, ap in cases:
        got = ap.find_endpoints(torch.from_numpy(wav).to(cuda))
        assert got.device.type == "cuda"
        assert got.cpu().tolist() == ap.find_endpoints(torch.from_numpy(wav)).tolist()


@pytest.mark.gpu
def test_card_at_the_synthesis_shapes(cuda):
    # vctk: [32, 275000] at 22.05 kHz; pod: [64, 500000] at 20 kHz
    for sr, B, N in ((22050, 32, 275000), (20000, 64, 500000)):
        ap, _, thr = processor(sr)
        g = torch.Generator(device=cuda).manual_seed(sr)
        wav = (torch.rand(B, N, generator=g, device=cuda) - 0.5) * (8 * thr)
        cut = torch.randint(0, N, (B,), generator=g, device=cuda)
        wav = torch.where(torch.arange(N, device=cuda) >= cut[:, None], wav * 0.1, wav)
        got = ap.find_endpoints(wav).cpu().tolist()
        assert got == ap.find_endpoints(wav.cpu()).tolist()
        assert got == host_endpoints(ap, wav.cpu().numpy())
