"""Synthetic speech-like corpus generator, for machines without a real corpus.

A copy of ``tacotron_multispeaker_tpu/data/synthetic.py`` (numpy and scipy
only), kept in the port so that it imports nothing of the JAX package.

Generates deterministic utterances whose audio is a per-character formant
pattern modulated by a per-speaker fundamental, so that text→audio has a
learnable monotonic structure (attention can align it) and multispeaker
conditioning is observable.  Written in the ``generic`` corpus layout
(``metadata.csv`` rows ``wav_path|speaker_id|text``) so it exercises the
exact preprocessing path a real corpus would.
"""

from __future__ import annotations

import os

import numpy as np
from scipy.io import wavfile

_WORDS = ["the", "quick", "brown", "fox", "jumps", "over", "lazy", "dog",
          "pack", "my", "box", "with", "five", "dozen", "liquor", "jugs",
          "how", "vexingly", "daft", "zebras"]


def _char_freq(c: str) -> float:
    """Stable per-character formant in speech range (300-3000 Hz)."""
    return 300.0 + (ord(c) % 32) * 85.0


def synth_utterance(text: str, speaker_id: int, sample_rate: int,
                    char_dur: float = 0.06) -> np.ndarray:
    f0 = 100.0 + 40.0 * (speaker_id % 8)          # per-speaker fundamental
    n_char = int(char_dur * sample_rate)
    segs = []
    for ch in text.lower():
        t = np.arange(n_char) / sample_rate
        if ch == " ":
            segs.append(np.zeros(n_char, np.float32))
            continue
        f = _char_freq(ch)
        env = np.hanning(n_char).astype(np.float32)
        s = (0.4 * np.sin(2 * np.pi * f * t) +
             0.3 * np.sin(2 * np.pi * f0 * t) +
             0.1 * np.sin(2 * np.pi * 2 * f * t))
        segs.append((s * env).astype(np.float32))
    return np.concatenate(segs) if segs else np.zeros(n_char, np.float32)


def make_corpus(out_dir: str, n_utts: int = 32, n_speakers: int = 1,
                sample_rate: int = 22050, seed: int = 0,
                min_words: int = 2, max_words: int = 6) -> str:
    """Write a generic-layout corpus; returns ``out_dir``."""
    rng = np.random.RandomState(seed)
    wav_dir = os.path.join(out_dir, "wavs")
    os.makedirs(wav_dir, exist_ok=True)
    rows = []
    for i in range(n_utts):
        n_words = rng.randint(min_words, max_words + 1)
        text = " ".join(_WORDS[rng.randint(len(_WORDS))]
                        for _ in range(n_words))
        sid = i % n_speakers
        wav = synth_utterance(text, sid, sample_rate)
        rel = f"wavs/utt{i:04d}.wav"
        wavfile.write(os.path.join(out_dir, rel), sample_rate,
                      (wav * 32767).astype(np.int16))
        rows.append(f"{rel}|{sid}|{text}")
    with open(os.path.join(out_dir, "metadata.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")
    return out_dir


def make_ljspeech_corpus(out_dir: str, n_utts: int = 500,
                         sample_rate: int = 20000, seed: int = 0,
                         min_words: int = 2, max_words: int = 10) -> str:
    """Write a synthetic corpus in the EXACT LJSpeech-1.1 layout
    (``metadata.csv`` rows ``id|raw|normalized``, ``wavs/<id>.wav``) so the
    real ``preprocess.py --dataset ljspeech`` path — not the generic
    builder — can be drilled end-to-end at a realistic utterance count
    (the JAX package's tools/corpus_drill.py)."""
    rng = np.random.RandomState(seed)
    wav_dir = os.path.join(out_dir, "wavs")
    os.makedirs(wav_dir, exist_ok=True)
    rows = []
    for i in range(n_utts):
        n_words = rng.randint(min_words, max_words + 1)
        text = " ".join(_WORDS[rng.randint(len(_WORDS))]
                        for _ in range(n_words))
        utt = f"LJ{i // 100 + 1:03d}-{i % 100:04d}"
        wav = synth_utterance(text, 0, sample_rate)
        wavfile.write(os.path.join(wav_dir, f"{utt}.wav"), sample_rate,
                      (wav * 32767).astype(np.int16))
        rows.append(f"{utt}|{text}|{text}")
    with open(os.path.join(out_dir, "metadata.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")
    return out_dir
