"""One generator for every mix.  Lengths come from a fixed set (quantiles of
the mix's length distribution), so every seed gets the same sizes; the seed
draws the words, the speakers, the order and the random streams of each
call.  The utterance audio is a copy of the port's synthetic corpus
generator (``data/synthetic.py``), kept here so a change there cannot move
the data."""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np
from scipy.io import wavfile
from scipy.stats import norm

WORDS = ["the", "quick", "brown", "fox", "jumps", "over", "lazy", "dog", "pack", "my",
         "box", "with", "five", "dozen", "liquor", "jugs", "how", "vexingly", "daft",
         "zebras", "sphinx", "of", "black", "quartz", "judge", "vow", "waltz", "nymph",
         "for", "jigs", "bad", "wizard", "glib", "jocks", "quiz", "vexed", "frozen"]


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2**63, *stream])


def length_set(n: int, lo: int, hi: int, median: float, sigma: float) -> np.ndarray:
    """n lengths: the quantiles (i + 0.5)/n of a log-normal of ``median`` and
    ``sigma`` cut to [lo, hi]."""
    a, b = norm.cdf(math.log(lo / median) / sigma), norm.cdf(math.log(hi / median) / sigma)
    u = a + (b - a) * (np.arange(n) + 0.5) / n
    return np.clip(np.rint(median * np.exp(sigma * norm.ppf(u))), lo, hi).astype(int)


def text_of(rng: np.random.Generator, n_chars: int) -> str:
    """Random words to ``n_chars`` characters, the last one a full stop."""
    words, size = [], -1
    while size < n_chars - 1:
        w = WORDS[rng.integers(len(WORDS))]
        words.append(w)
        size += len(w) + 1
    text = " ".join(words)[: n_chars - 1]
    return (text[:-1] + "s" if text.endswith(" ") else text) + "."


@dataclass
class Call:
    """One ``synthesize_batch`` call."""
    texts: list
    speaker_ids: list
    bucket: int
    seed: int


def synth_calls(mix: dict, num_speakers: int, seed: int):
    """Endless synthesis calls in blocks of ``block`` calls: in each block the
    same buckets (a call's texts share one input bucket, as a catalogue job
    groups them) with the same text lengths, in an order drawn from the seed;
    words, speakers and each call's random seed drawn from the seed."""
    B, block = mix["batch"], mix["block"]
    lengths = length_set(B * block, mix["min_chars"], mix["max_chars"], mix["median_chars"],
                         mix["sigma"])
    buckets = mix["buckets"]
    # encoded length = characters + the end-of-sequence id
    by_bucket = {b: [] for b in buckets}
    for n in lengths:
        by_bucket[next(b for b in buckets if n + 1 <= b)].append(int(n))
    plan = []
    for b in buckets:
        ns = by_bucket[b]
        for i in range(0, len(ns) - len(ns) % B, B):
            plan.append((b, ns[i: i + B]))
    rng = rng_for(seed, 1)
    while True:
        for j in rng.permutation(len(plan)):
            b, ns = plan[j]
            texts = [text_of(rng, n) for n in rng.permutation(ns)]
            sids = rng.integers(0, num_speakers, size=len(texts)).tolist()
            yield Call(texts, sids, b, int(rng.integers(0, 2**62)))


def char_freq(c: str) -> float:
    return 300.0 + (ord(c) % 32) * 85.0


def synth_utterance(text: str, speaker_id: int, sample_rate: int,
                    char_dur: float = 0.06) -> np.ndarray:
    """Per-character formant pattern over a per-speaker fundamental."""
    f0 = 100.0 + 40.0 * (speaker_id % 8)
    n_char = int(char_dur * sample_rate)
    t = np.arange(n_char) / sample_rate
    env = np.hanning(n_char).astype(np.float32)
    segs = []
    for ch in text.lower():
        if ch == " ":
            segs.append(np.zeros(n_char, np.float32))
            continue
        f = char_freq(ch)
        s = (0.4 * np.sin(2 * np.pi * f * t) + 0.3 * np.sin(2 * np.pi * f0 * t)
             + 0.1 * np.sin(2 * np.pi * 2 * f * t))
        segs.append((s * env).astype(np.float32))
    return np.concatenate(segs) if segs else np.zeros(n_char, np.float32)


def corpus(mix: dict, num_speakers: int, seed: int) -> list[tuple[str, int]]:
    """(text, speaker id) of each utterance: the length set in an order drawn
    from the seed, every text distinct."""
    rng = rng_for(seed, 2)
    lengths = length_set(mix["utterances"], mix["min_chars"], mix["max_chars"],
                         mix["median_chars"], mix["sigma"])
    rows, seen = [], set()
    for n in rng.permutation(lengths):
        text = text_of(rng, int(n))
        while text in seen:
            text = text_of(rng, int(n))
        seen.add(text)
        rows.append((text, int(rng.integers(0, num_speakers))))
    return rows


def write_corpus(out_dir: str, rows, sample_rate: int, char_dur: float) -> str:
    """The generic corpus layout (``metadata.csv``: wav|speaker|text)."""
    os.makedirs(os.path.join(out_dir, "wavs"), exist_ok=True)
    lines = []
    for i, (text, sid) in enumerate(rows):
        wav = synth_utterance(text, sid, sample_rate, char_dur)
        rel = f"wavs/utt{i:05d}.wav"
        wavfile.write(os.path.join(out_dir, rel), sample_rate, (wav * 32767).astype(np.int16))
        lines.append(f"{rel}|{sid}|{text}")
    with open(os.path.join(out_dir, "metadata.csv"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return out_dir
