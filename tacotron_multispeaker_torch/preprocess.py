"""Preprocessing entry point of the port.

    python -m tacotron_multispeaker_torch.preprocess --dataset ljspeech \
        --in_dir ~/LJSpeech-1.1 --base_dir ./runs --preset single_speaker
    python -m tacotron_multispeaker_torch.preprocess --dataset synthetic \
        --base_dir ./runs --preset tiny [--device cpu --num_workers 4]

Writes ``<base_dir>/<output>/train.txt`` and the feature files in the JAX
package's format.  The flags are the root ``preprocess.py``'s, with
``--device`` (default: the CUDA device): features are computed on the card
in this process, or, with ``--device cpu``, in ``--num_workers`` worker
processes on the CPU.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> str:
    from .data.preprocess import CORPORA, write_metadata
    p = argparse.ArgumentParser(prog="python -m tacotron_multispeaker_torch.preprocess")
    p.add_argument("--base_dir", default="./runs")
    p.add_argument("--output", default="training")
    p.add_argument("--dataset", required=True, choices=sorted(CORPORA) + ["synthetic"])
    p.add_argument("--in_dir", default=None, help="corpus root (not needed for synthetic)")
    p.add_argument("--preset", default="single_speaker")
    p.add_argument("--hparams", default="", help="comma-separated dotted overrides")
    p.add_argument("--num_workers", type=int, default=1,
                   help="worker processes (more than 1 needs --device cpu)")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--keep_wavs", action="store_true",
                   help="also write <utt>-wav.npy int16 PCM next to the feature files")
    p.add_argument("--device", default=None,
                   help="torch device for the features (default: the CUDA device)")
    # synthetic corpus knobs
    p.add_argument("--n_utts", type=int, default=64)
    p.add_argument("--n_speakers", type=int, default=1)
    args = p.parse_args(argv)

    from .config import get_config
    cfg = get_config(args.preset, args.hparams)
    out_dir = os.path.join(args.base_dir, args.output)
    os.makedirs(out_dir, exist_ok=True)
    if args.dataset == "synthetic":
        from .data.synthetic import make_corpus
        in_dir = os.path.join(args.base_dir, "synthetic_corpus")
        make_corpus(in_dir, n_utts=args.n_utts, n_speakers=args.n_speakers,
                    sample_rate=cfg.audio.sample_rate)
        build = CORPORA["generic"]
    else:
        in_dir = args.in_dir
        if in_dir is None:
            p.error(f"--in_dir required for dataset {args.dataset}")
        build = CORPORA[args.dataset]
    metadata = build(in_dir, out_dir, cfg.audio, num_workers=args.num_workers,
                     limit=args.limit, keep_wavs=args.keep_wavs, device=args.device)
    return write_metadata(metadata, out_dir, cfg.audio)


if __name__ == "__main__":
    main()
