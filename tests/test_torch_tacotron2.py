"""The port's Tacotron 2 + SV2TTS (``models/tacotron2.py``) against its plain
float32 reference (``tests/tacotron2_reference.py``) at the
``tacotron2_tiny`` preset on the CPU, on seeded random weights with the
same prenet masks; its pieces (zoneout, the speaker vectors, the stop frame,
``mel_to_linear``) against their definitions; ``synthesize_batch`` end to
end.  The ``gpu`` case holds the card's graph-replayed decode against its
eager step loop, bit for bit, with the attention kernel's launches counted
through the replays, and skips without a card.  Imports no JAX."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from tacotron_multispeaker_torch.audio import dsp
from tacotron_multispeaker_torch.config import get_config
from tacotron_multispeaker_torch.models import Tacotron2, create_model
from tacotron_multispeaker_torch.models.modules import BatchNorm
from tacotron_multispeaker_torch.ops import attention_step as as_ops
from tacotron_multispeaker_torch.models.tacotron2 import GRAPH_STEPS, lstm_update, stop_frames
from tacotron_multispeaker_torch.synthesizer import Synthesizer
from tacotron_multispeaker_torch.text import text_to_sequence

import tacotron2_reference as ref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXTS = ["hello world.", "a longer text, said twice over.", "short.",
         "the quick brown fox jumps."]
SPEAKERS = [0, 3, 1, 2]


def model(overrides=None, seed=0):
    cfg = get_config("tacotron2_tiny", overrides)
    m = create_model(cfg.model.architecture, cfg).reset_parameters(
        torch.Generator().manual_seed(seed)).eval()
    with torch.no_grad():   # non-trivial BatchNorm statistics and biases
        g = torch.Generator().manual_seed(seed + 1)
        for bn in (mod for mod in m.modules() if isinstance(mod, BatchNorm)):
            bn.mean.normal_(0.0, 0.1, generator=g)
            bn.var.uniform_(0.5, 1.5, generator=g)
            bn.scale.uniform_(0.8, 1.2, generator=g)
            bn.bias.normal_(0.0, 0.1, generator=g)
        for name, p in m.named_parameters():
            if p.dim() == 1 and name.rsplit(".", 1)[-1].startswith("bias"):
                p.normal_(0.0, 0.1, generator=g)
    return cfg, m


def batch(cfg, L=32):
    seqs = [np.asarray(text_to_sequence(t, cfg.cleaners)) for t in TEXTS]
    inputs = torch.as_tensor(np.stack([np.pad(s, (0, L - len(s))) for s in seqs]))
    return inputs, torch.as_tensor([len(s) for s in seqs]), torch.as_tensor(SPEAKERS)


def reference(cfg, m, inputs, lengths, sids, S, seed):
    gen = torch.Generator().manual_seed(seed)
    W = {k: v.float() for k, v in m.state_dict().items()}
    r = ref.Tacotron2(W, json.loads(json.dumps(dataclasses.asdict(cfg))))
    with torch.no_grad():
        return r.generate(inputs, lengths, sids, S, lambda shape: torch.rand(shape, generator=gen))


def test_port_matches_the_plain_reference():
    # f32 at the tiny preset: the same products in other orders (the folded
    # location conv, one concatenated matrix an LSTM, lerp for zoneout) -> 1e-4;
    # the linear spectrogram's dB of the pseudo-inverse's near-zero amplitudes
    # (where the clamp sits) magnifies that gap: 2e-3 there
    cfg, m = model()
    m.train()                     # inference only: the BatchNorms keep their statistics
    assert not any(mod.training for mod in m.modules())
    inputs, lengths, sids = batch(cfg)
    S = cfg.model.max_iters
    with torch.no_grad():
        out = m.generate(inputs, lengths, sids, generator=torch.Generator().manual_seed(5))
    post, linear, aligns, stops, frames = reference(cfg, m, inputs, lengths, sids, S, 5)
    for name, a, b in [("decoder mel", out.mel_outputs, frames), ("post-net mel",
                       out.postnet_outputs, post), ("alignments", out.alignments, aligns),
                       ("stop logits", out.stop_logits, stops),
                       ("linear", out.linear_outputs, linear)]:
        assert a.shape == b.shape, name
        tol = 2e-3 if name == "linear" else 1e-4
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=tol, err_msg=name)
    assert out.alignments.shape == (4, S, 32)
    # no weight on a padded position, every step's alignments sum to one
    mask = torch.arange(32)[None, :] < lengths[:, None]
    assert float(out.alignments.masked_select(~mask[:, None, :]).abs().max()) == 0.0
    np.testing.assert_allclose(out.alignments.sum(-1).numpy(), 1.0, atol=1e-5)
    assert torch.equal(out.stop_frames, ref.stop_frames(stops, cfg.model.stop_threshold))


def test_port_is_independent_of_the_padding():
    # the encoder's padding is zeroed before each conv and the backward LSTM
    # starts at each row's last position: a longer pad changes nothing
    cfg, m = model()
    with torch.no_grad():
        a = m.generate(*batch(cfg, 32), generator=torch.Generator().manual_seed(2))
        b = m.generate(*batch(cfg, 64), generator=torch.Generator().manual_seed(2))
    np.testing.assert_allclose(a.postnet_outputs.numpy(), b.postnet_outputs.numpy(), atol=1e-5)
    np.testing.assert_allclose(a.alignments.numpy(), b.alignments[..., :32].numpy(), atol=1e-6)


@pytest.mark.parametrize("zoneout", [0.0, 0.1, 0.5])
def test_zoneout_rule(zoneout):
    # torch.nn.LSTMCell's update, then c = z*c_prev + (1-z)*c', the same for h
    torch.manual_seed(0)
    cell = torch.nn.LSTMCell(6, 5)
    x, h, c = torch.randn(3, 6), torch.randn(3, 5), torch.randn(3, 5)
    h_new, c_new = cell(x, (h, c))
    gates = x @ cell.weight_ih.t() + h @ cell.weight_hh.t() + cell.bias_ih + cell.bias_hh
    hh, cc = h.clone(), c.clone()
    with torch.no_grad():
        lstm_update(gates, hh, cc, zoneout)
    np.testing.assert_allclose(cc.numpy(), (zoneout * c + (1 - zoneout) * c_new).detach().numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(hh.numpy(), (zoneout * h + (1 - zoneout) * h_new).detach().numpy(),
                               rtol=1e-6, atol=1e-6)


def test_speaker_vectors_are_unit_rows_at_every_position():
    cfg, m = model()
    inputs, lengths, sids = batch(cfg)
    E = cfg.model.speaker_embed_depth
    with torch.no_grad():
        spk = m.speaker_vectors(sids)
        memory = m.encode(inputs, lengths, spk)
    table = m.speaker_table.weight[sids]
    np.testing.assert_allclose(spk.norm(dim=-1).numpy(), 1.0, rtol=1e-6)
    np.testing.assert_allclose(spk.numpy(), (table / table.norm(dim=-1, keepdim=True))
                               .detach().numpy(), rtol=1e-6)
    assert memory.shape == (4, 32, 2 * cfg.model.encoder_lstm_units + E) == (
        4, 32, m.memory_depth)
    for t in range(32):
        assert torch.equal(memory[:, t, -E:], spk)


def test_stop_frame_against_a_host_loop():
    rs = np.random.RandomState(0)
    logits = torch.as_tensor(rs.uniform(-6, -1, (6, 40)), dtype=torch.float32)
    logits[1, 7] = 0.5            # stops at step 8
    logits[2, 0] = 3.0            # at the first step
    logits[3, 39] = 1.0           # at the last
    logits[4, [5, 9]] = 2.0       # the first of two
    logits[5, 11] = 0.0           # sigma = 0.5 exactly: not above the threshold
    got = stop_frames(logits, 0.5)
    assert got.dtype == torch.int64
    assert got.tolist() == ref.stop_frames(logits, 0.5).tolist() == [40, 8, 1, 40, 6, 40]


def test_mel_to_linear_against_numpy_pinv():
    a = get_config("tacotron2_tiny").audio
    rs = np.random.RandomState(1)
    mel = rs.uniform(0.0, 1.0, (2, 7, a.num_mels)).astype(np.float32)
    got = dsp.mel_to_linear(torch.as_tensor(mel), sample_rate=a.sample_rate, n_fft=a.n_fft,
                            ref_level_db=a.ref_level_db, min_level_db=a.min_level_db)
    basis = dsp.mel_basis(a.sample_rate, a.n_fft, a.num_mels).astype(np.float64)
    amp = 10.0 ** ((np.clip(mel, 0, 1) * -a.min_level_db + a.min_level_db + a.ref_level_db) / 20)
    lin = np.maximum(amp @ np.linalg.pinv(basis).T, 1e-10)
    db = 20 * np.log10(np.maximum(lin, 1e-5)) - a.ref_level_db
    want = np.clip((db - a.min_level_db) / -a.min_level_db, 0, 1)
    assert got.shape == (2, 7, a.num_freq)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_synthesize_batch_cuts_rows_at_the_stop_frame(monkeypatch):
    cfg = get_config("tacotron2_tiny")
    s = Synthesizer(cfg, device="cpu", seed=0)
    with torch.no_grad():
        s.model.stop_proj.weight.zero_()
        s.model.frame_proj.bias.fill_(0.6)       # loud frames: no silence endpoint
    kept = []
    make_fn = s._make_fn

    def spy(*args, **kw):
        fn = make_fn(*args, **kw)

        def run(*a):
            out = fn(*a)
            kept.append([t.clone() for t in out])
            return out
        return run
    monkeypatch.setattr(s, "_make_fn", spy)
    # rows stop where the stop logit's bias says: 3 rows stop at once, 1 never
    with torch.no_grad():
        s.model.stop_proj.bias.fill_(1.0)
    wavs, aligns = s.synthesize_batch(TEXTS[:3], SPEAKERS[:3], seed=1, pad_to=32)
    (wav, al, mel, stops), = kept
    hop = cfg.audio.hop_length
    assert stops.tolist() == [1, 1, 1] and [len(w) for w in wavs] == [hop] * 3
    assert aligns.shape == (3, cfg.model.max_iters, 32) and np.array_equal(aligns, al.numpy())
    kept.clear()
    with torch.no_grad():
        s.model.stop_proj.bias.fill_(-10.0)
    wavs, _ = s.synthesize_batch(TEXTS[:3], SPEAKERS[:3], seed=1, pad_to=32)
    (wav, _, _, stops), = kept
    assert stops.tolist() == [cfg.model.max_iters] * 3
    for w, row in zip(wavs, wav.numpy()):
        e = s.ap.find_endpoint(row)
        assert np.array_equal(w, row[:e])


def test_synthesize_batch_row_is_min_of_stop_and_endpoint(monkeypatch):
    # a stop frame decided by one row's logits: the Synthesizer's cut is the
    # smaller of the stop frame x hop and the silence endpoint, row by row
    cfg = get_config("tacotron2_tiny")
    s = Synthesizer(cfg, device="cpu", seed=0)
    kept = []
    make_fn = s._make_fn
    monkeypatch.setattr(s, "_make_fn", lambda *a, **kw: (
        lambda *b: kept.append(make_fn(*a, **kw)(*b)) or kept[-1]))
    wavs, _ = s.synthesize_batch(TEXTS, SPEAKERS, seed=3, pad_to=32)
    wav, _, _, stops = kept[0]
    hop = cfg.audio.hop_length
    for w, row, st in zip(wavs, wav.numpy(), stops.tolist()):
        assert len(w) == min(st * hop, s.ap.find_endpoint(row))
        assert np.array_equal(w, row[:len(w)])


@pytest.mark.parametrize("preset", ["multispeaker_vctk", "pod_synthesis"])
def test_tacotron1_presets_give_their_configuration_files(preset):
    # the benchmark's configuration files state every setting as run; the
    # Tacotron 2 fields leave the Tacotron-1 presets as they were
    with open(os.path.join(ROOT, "benchmark", "configs", f"{preset}.json")) as f:
        data = json.load(f)
    cfg = get_config(data["preset"], data["overrides"] or None)
    port = json.loads(json.dumps(dataclasses.asdict(cfg)))
    for section, values in data["resolved"].items():
        assert port[section] == values if not isinstance(values, dict) else all(
            port[section][k] == v for k, v in values.items()), section
    assert cfg.model.architecture == "tacotron"
    assert type(create_model(cfg.model.architecture, cfg)).__name__ == "Tacotron"


def test_published_widths():
    cfg = get_config("tacotron2_sv2tts")
    m = create_model(cfg.model.architecture, cfg)
    assert isinstance(m, Tacotron2) and m.memory_depth == 768
    shapes = {k: tuple(v.shape) for k, v in m.state_dict().items()}
    assert shapes["attention_rnn.weight_ih"] == (4096, 256 + 768)
    assert shapes["decoder_rnn.weight_hh"] == (4096, 1024)
    assert shapes["speaker_table.weight"] == (109, 256)
    assert shapes["encoder_convs.2.conv.weight"] == (512, 512, 5)
    assert shapes["postnet.4.conv.weight"] == (80, 512, 5)
    assert shapes["attention.loc_conv.weight"] == (32, 1, 31)
    n = sum(v.numel() for k, v in m.state_dict().items() if not k.endswith((".mean", ".var")))
    assert 29e6 < n < 31.5e6


@pytest.mark.gpu
@pytest.mark.parametrize("use_pallas", [True, False])
def test_graph_replayed_decode_is_the_eager_loop_bit_for_bit(use_pallas):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: python -m pytest -m gpu tests/test_torch_*.py")
    cfg, m = model(f"model.compute_dtype=bfloat16,parallel.use_pallas={use_pallas}")
    dev = torch.device("cuda")
    m = m.to(dev)
    inputs, lengths, sids = (t.to(dev) for t in batch(cfg, 64))
    S = 2 * GRAPH_STEPS                                       # two replays
    gen = torch.Generator(device=dev).manual_seed(4)
    with torch.inference_mode():
        memory = m.encode(inputs, lengths, m.speaker_vectors(sids)).contiguous()
        keys = m.attention.precompute_keys(memory).contiguous()
        mask = torch.arange(64, device=dev)[None, :] < lengths[:, None]
        masks = [(torch.rand((S, 4, n), generator=gen, device=dev) < 0.5).float() * 2.0
                 for n in cfg.model.prenet_depths]
        graph = m.decode(keys, memory, mask, masks, S)
        before = as_ops.launches
        again = m.decode(keys, memory, mask, masks, S)
        replayed = as_ops.launches - before
        eager = m.decode_eager(keys, memory, mask, masks, S)
    assert graph[3] == 2
    # the attention kernel's counter sees the replays: a launch a step
    assert replayed == (S if use_pallas else 0)
    for a, b, c in zip(graph[:3], again[:3], eager):
        assert torch.equal(a, b) and torch.equal(a, c)
