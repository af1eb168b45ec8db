"""Offline corpus preprocessing: wav -> (mel, linear) .npy pairs + metadata.

Port of ``tacotron_multispeaker_tpu/data/preprocess.py``.  Each corpus
builder reads corpus metadata + wavs, computes mel [T, num_mels] and linear
[T, num_freq] spectrograms (``AudioProcessor``, on its device), writes them
as ``.npy``, and emits ``train.txt`` rows
``linear_file|mel_file|n_frames|speaker_id|text`` in the JAX package's
format, so that either package reads a corpus the other wrote.

Where the features are computed: ``device=None`` is the card (and raises
without one), featurising in this process (``num_workers`` 1).  Several
worker processes featurise on the CPU, and only when the caller asks for
it (``device="cpu"``): nothing moves to the CPU on its own.
"""

from __future__ import annotations

import csv
import functools
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Callable, Iterable

import numpy as np

from ..device import resolve_device

METADATA_FIELDS = ("linear_file", "mel_file", "n_frames", "speaker_id", "text")


@functools.lru_cache(maxsize=1)
def _get_processor(audio_cfg, device):
    """The AudioProcessor of this process (one per worker)."""
    from ..audio import AudioProcessor
    return AudioProcessor(audio_cfg, device)


def process_utterance(out_dir: str, index: str, wav_path: str, text: str,
                      speaker_id: int, audio_cfg, keep_wav: bool = False,
                      device=None) -> tuple | None:
    """Featurize one utterance; returns a metadata row tuple or None.

    ``keep_wav`` additionally writes the int16 PCM as ``{index}-wav.npy``
    (the input of ``train.targets_from_wav``, which the port has not ported
    yet; the files are the JAX package's)."""
    ap = _get_processor(audio_cfg, resolve_device(device))
    try:
        wav = ap.load_wav(wav_path)
    except (ValueError, FileNotFoundError) as e:
        print(f"skip {wav_path}: {e}")
        return None
    linear = np.ascontiguousarray(ap.spectrogram(wav).astype(np.float32).T)     # [T, num_freq]
    mel = np.ascontiguousarray(ap.melspectrogram(wav).astype(np.float32).T)     # [T, num_mels]
    n_frames = linear.shape[0]
    linear_file = f"{index}-linear.npy"
    mel_file = f"{index}-mel.npy"
    np.save(os.path.join(out_dir, linear_file), linear, allow_pickle=False)
    np.save(os.path.join(out_dir, mel_file), mel, allow_pickle=False)
    if keep_wav:
        # exact int16 round-trip of load_wav's /32768 scaling
        pcm = np.clip(np.round(wav * 32768.0), -32768, 32767).astype(np.int16)
        np.save(os.path.join(out_dir, f"{index}-wav.npy"), pcm, allow_pickle=False)
    return (linear_file, mel_file, n_frames, speaker_id, text)


def _run_jobs(jobs, out_dir: str, audio_cfg, num_workers: int,
              keep_wavs: bool = False, device=None):
    os.makedirs(out_dir, exist_ok=True)
    dev = resolve_device(device)
    if num_workers <= 1:
        results = [process_utterance(out_dir, *job, audio_cfg, keep_wavs, dev)
                   for job in jobs]
    else:
        if dev.type != "cpu":
            raise ValueError(f"num_workers={num_workers}: worker processes featurise on "
                             "the CPU; pass device='cpu' for them, or num_workers=1 to "
                             f"featurise on {dev}")
        # spawn, not fork: workers start from a fresh import (no inherited
        # threads or locks of this process)
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=num_workers, mp_context=ctx) as ex:
            results = list(ex.map(_job_wrapper,
                                  [(out_dir, *j, audio_cfg, keep_wavs) for j in jobs]))
    return [r for r in results if r is not None]


def _job_wrapper(packed):
    out_dir, index, wav_path, text, speaker_id, audio_cfg, keep_wav = packed
    return process_utterance(out_dir, index, wav_path, text, speaker_id, audio_cfg,
                             keep_wav, "cpu")


def wav_file_for(row: dict) -> str:
    """The ``--keep_wavs`` PCM filename for a metadata row (basename
    convention: ``<index>-linear.npy`` ↔ ``<index>-wav.npy``)."""
    lf = row["linear_file"]
    suffix = "-linear.npy"
    if not lf.endswith(suffix):
        raise ValueError(f"cannot derive wav filename from {lf!r}")
    return lf[: -len(suffix)] + "-wav.npy"


# ----------------------------------------------------------------------------
# Corpus builders (reference: build_from_path per corpus module)
# ----------------------------------------------------------------------------

def build_ljspeech(in_dir: str, out_dir: str, audio_cfg, num_workers: int = 1,
                   limit: int | None = None, keep_wavs: bool = False, device=None):
    """LJSpeech-1.1 layout: metadata.csv with ``id|text|normalized_text``."""
    jobs = []
    with open(os.path.join(in_dir, "metadata.csv"), encoding="utf-8") as f:
        for i, line in enumerate(f):
            if limit is not None and i >= limit:
                break
            parts = line.strip().split("|")
            wav_path = os.path.join(in_dir, "wavs", f"{parts[0]}.wav")
            text = parts[2] if len(parts) > 2 else parts[1]
            jobs.append((f"ljspeech-{i:05d}", wav_path, text, 0))
    return _run_jobs(jobs, out_dir, audio_cfg, num_workers, keep_wavs, device)


def build_vctk(in_dir: str, out_dir: str, audio_cfg, num_workers: int = 1,
               limit: int | None = None, keep_wavs: bool = False, device=None):
    """VCTK layout: txt/<spk>/<utt>.txt + wav48/<spk>/<utt>.wav.

    Speaker ids are assigned by sorted speaker-directory order so they are
    stable across runs; the mapping is written to ``speakers.txt``.
    """
    txt_root = os.path.join(in_dir, "txt")
    wav_root = None
    for cand in ("wav48", "wav", "wavs"):
        if os.path.isdir(os.path.join(in_dir, cand)):
            wav_root = os.path.join(in_dir, cand)
            break
    if wav_root is None or not os.path.isdir(txt_root):
        raise FileNotFoundError(f"no VCTK layout under {in_dir}")
    speakers = sorted(os.listdir(txt_root))
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "speakers.txt"), "w") as f:
        for sid, spk in enumerate(speakers):
            f.write(f"{sid}|{spk}\n")
    jobs = []
    n = 0
    for sid, spk in enumerate(speakers):
        spk_txt = os.path.join(txt_root, spk)
        for txt_file in sorted(os.listdir(spk_txt)):
            if not txt_file.endswith(".txt"):
                continue
            utt = txt_file[:-4]
            wav_path = os.path.join(wav_root, spk, f"{utt}.wav")
            if not os.path.exists(wav_path):
                continue
            if limit is not None and n >= limit:
                break
            with open(os.path.join(spk_txt, txt_file), encoding="utf-8") as f:
                text = f.read().strip()
            jobs.append((f"vctk-{utt}", wav_path, text, sid))
            n += 1
    return _run_jobs(jobs, out_dir, audio_cfg, num_workers, keep_wavs, device)


def build_generic(in_dir: str, out_dir: str, audio_cfg, num_workers: int = 1,
                  limit: int | None = None, keep_wavs: bool = False, device=None):
    """Generic layout: ``metadata.csv`` rows ``wav_path|speaker_id|text``
    (wav_path relative to in_dir)."""
    jobs = []
    with open(os.path.join(in_dir, "metadata.csv"), encoding="utf-8") as f:
        for i, line in enumerate(f):
            if limit is not None and i >= limit:
                break
            wav_rel, sid, text = line.strip().split("|", 2)
            jobs.append((f"utt-{i:06d}", os.path.join(in_dir, wav_rel), text, int(sid)))
    return _run_jobs(jobs, out_dir, audio_cfg, num_workers, keep_wavs, device)


def build_blizzard(in_dir: str, out_dir: str, audio_cfg, num_workers: int = 1,
                   limit: int | None = None, keep_wavs: bool = False, device=None):
    """Blizzard-2012 segmented layout: ``<book>/sentence_index.txt`` rows
    ``wav_filename<TAB>...<TAB>text`` under each book directory, wavs in
    ``<book>/wav/``."""
    books = [d for d in sorted(os.listdir(in_dir)) if os.path.isdir(os.path.join(in_dir, d))]
    jobs = []
    n = 0
    for book in books:
        index = os.path.join(in_dir, book, "sentence_index.txt")
        if not os.path.exists(index):
            continue
        with open(index, encoding="utf-8") as f:
            for line in f:
                parts = line.strip().split("\t")
                if len(parts) < 2 or not parts[0]:
                    continue
                if limit is not None and n >= limit:
                    break
                wav_path = os.path.join(in_dir, book, "wav", parts[0])
                text = parts[-1].strip()
                jobs.append((f"blizzard-{book}-{n:05d}", wav_path, text, 0))
                n += 1
    return _run_jobs(jobs, out_dir, audio_cfg, num_workers, keep_wavs, device)


def build_thchs30(in_dir: str, out_dir: str, audio_cfg, num_workers: int = 1,
                  limit: int | None = None, keep_wavs: bool = False, device=None):
    """THCHS-30 layout: ``<utt>.wav`` + ``<utt>.wav.trn`` pairs (trn line 1 =
    hanzi, line 2 = toned pinyin, line 3 = phones) either directly in
    ``in_dir`` or under ``in_dir/data``.  The toned-pinyin line is the text;
    the speaker is the filename prefix before ``_`` (``A11_102.wav`` →
    ``A11``), mapped to integer ids by sorted order (``speakers.txt``).
    """
    root = in_dir
    if not any(f.endswith(".trn") for f in os.listdir(root)):
        cand = os.path.join(in_dir, "data")
        if os.path.isdir(cand):
            root = cand
    trns = sorted(f for f in os.listdir(root) if f.endswith(".wav.trn"))
    if not trns:
        raise FileNotFoundError(f"no .wav.trn files under {in_dir}")
    raw_jobs = []  # (utt, wav_path, pinyin, speaker_name)
    for trn in trns:
        utt = trn[: -len(".wav.trn")]
        wav_path = os.path.join(root, f"{utt}.wav")
        if not os.path.exists(wav_path):
            continue
        with open(os.path.join(root, trn), encoding="utf-8") as f:
            lines = [ln.strip() for ln in f.readlines() if ln.strip()]
        # in the released corpus train/dev/test trns are one-line pointers
        # to ../data/<utt>.wav.trn: follow the pointer to the real trn
        if len(lines) == 1:
            target = os.path.normpath(os.path.join(root, lines[0]))
            if os.path.exists(target):
                with open(target, encoding="utf-8") as f:
                    lines = [ln.strip() for ln in f.readlines() if ln.strip()]
        if len(lines) < 2:
            continue
        raw_jobs.append((utt, wav_path, lines[1], utt.split("_", 1)[0]))
        # limit counts accepted utterances, not scanned files
        if limit is not None and len(raw_jobs) >= limit:
            break
    if not raw_jobs:
        raise ValueError(
            f"all {len(trns)} .trn files under {root} were skipped (missing "
            "wavs or malformed transcripts) — for the released corpus point "
            "--in_dir at the root or data/ dir, or a train/ dir whose trn "
            "pointers resolve")
    # speaker ids from the emitted utterances, so speakers.txt matches the output
    speakers = sorted({j[3] for j in raw_jobs})
    spk_to_id = {s: i for i, s in enumerate(speakers)}
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "speakers.txt"), "w") as f:
        for spk, sid in spk_to_id.items():
            f.write(f"{sid}|{spk}\n")
    jobs = [(f"thchs30-{utt}", wav_path, pinyin, spk_to_id[spk])
            for utt, wav_path, pinyin, spk in raw_jobs]
    return _run_jobs(jobs, out_dir, audio_cfg, num_workers, keep_wavs, device)


CORPORA: dict[str, Callable] = {
    "ljspeech": build_ljspeech,
    "vctk": build_vctk,
    "blizzard": build_blizzard,
    "thchs30": build_thchs30,
    "generic": build_generic,
}


def write_metadata(metadata: Iterable[tuple], out_dir: str, audio_cfg=None) -> str:
    """Write train.txt and return its path; prints corpus stats."""
    rows = list(metadata)
    path = os.path.join(out_dir, "train.txt")
    with open(path, "w", encoding="utf-8", newline="") as f:
        w = csv.writer(f, delimiter="|")
        for row in rows:
            w.writerow(row)
    frames = sum(int(r[2]) for r in rows)
    n_spk = len({r[3] for r in rows})
    hours = "?"
    if audio_cfg is not None:
        hours = f"{frames * audio_cfg.hop_length / audio_cfg.sample_rate / 3600:.2f}"
    print(f"Wrote {len(rows)} utterances, {frames} frames, {n_spk} speakers ({hours} hours)")
    return path


def load_metadata(metadata_path: str) -> list[dict]:
    """Parse train.txt rows into dicts."""
    rows = []
    with open(metadata_path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("|", 4)
            if len(parts) != 5:
                continue
            rows.append({
                "linear_file": parts[0],
                "mel_file": parts[1],
                "n_frames": int(parts[2]),
                "speaker_id": int(parts[3]),
                "text": parts[4],
            })
    return rows
