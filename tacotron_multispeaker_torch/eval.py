"""Batch synthesis: sentences → WAV files.

    python -m tacotron_multispeaker_torch.eval --checkpoint_dir runs/logs-tiny/checkpoints \
        --preset tiny [--text "Hello." ...] [--text_file lines.txt] [--speaker_id 0] \
        [--batch_size 8] [--out_dir eval_out] [--device cpu]

Port of the root ``eval.py``: synthesizes the built-in eval sentences (or
``--text`` / ``--text_file``) from a checkpoint into ``<out_dir>/eval-<i>.wav``,
``i`` the sentence's index.  Sentences run in batches of ``--batch_size``
grouped by serving input bucket (:func:`group_by_bucket`), each batch padded
to its bucket.  Runs on the CUDA device unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os

# phonetically balanced eval sentences (the JAX package's list)
SENTENCES = [
    "The juke box music puzzled a gentle visitor from a quaint valley town.",
    "Researchers counted eleven thousand four hundred samples in the archive.",
    "Will the weather hold long enough for the final match on Saturday?",
    "A mixture of zinc and copper makes a surprisingly durable alloy.",
    "She sells seashells by the seashore, or so the old rhyme claims.",
    "Does the quick brown fox really jump over the lazy sleeping dog?",
    "Synthesis quality depends on alignment, prosody, and spectral detail.",
]


def group_by_bucket(syn, texts: list[str], batch_size: int):
    """Yield (original indices, sentences) chunks of at most ``batch_size``,
    grouped by serving input bucket in ascending bucket order, each bucket's
    sentences in their original order: one padded shape per occupied
    bucket, as serving pads."""
    by_bucket: dict[int, list[int]] = {}
    for i, t in enumerate(texts):
        by_bucket.setdefault(syn.serve_bucket_for([t]), []).append(i)
    for b in sorted(by_bucket):
        idxs = by_bucket[b]
        for j0 in range(0, len(idxs), batch_size):
            idx = idxs[j0: j0 + batch_size]
            yield idx, [texts[i] for i in idx]


def main(argv=None) -> list[str]:
    p = argparse.ArgumentParser(prog="python -m tacotron_multispeaker_torch.eval")
    p.add_argument("--checkpoint_dir", required=True, help=".../logs-<run>/checkpoints")
    p.add_argument("--preset", default="single_speaker")
    p.add_argument("--hparams", default="")
    p.add_argument("--out_dir", default="eval_out")
    p.add_argument("--speaker_id", type=int, default=0)
    p.add_argument("--text", action="append", default=None)
    p.add_argument("--text_file", default=None)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device; cpu runs the plain "
                        "PyTorch path)")
    args = p.parse_args(argv)

    from .config import get_config
    from .synthesizer import Synthesizer
    cfg = get_config(args.preset, args.hparams)
    texts = args.text
    if args.text_file:
        with open(args.text_file) as f:
            texts = [ln.strip() for ln in f if ln.strip()]
    if not texts:
        texts = SENTENCES

    os.makedirs(args.out_dir, exist_ok=True)
    syn = Synthesizer(cfg, device=args.device).load(args.checkpoint_dir)
    paths = []
    for idx, chunk in group_by_bucket(syn, texts, args.batch_size):
        wavs, _ = syn.synthesize_batch(chunk, [args.speaker_id] * len(chunk),
                                       pad_to=syn.serve_bucket_for(chunk))
        for j, wav in enumerate(wavs):
            path = os.path.join(args.out_dir, f"eval-{idx[j]}.wav")
            syn.ap.save_wav(wav, path)
            print(f"{path}: {chunk[j][:60]!r}")
            paths.append(path)
    return paths


if __name__ == "__main__":
    main()
