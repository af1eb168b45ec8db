"""Validation: teacher-forced losses per speaker over a preprocessed corpus.

    python -m tacotron_multispeaker_torch.validate --checkpoint_dir runs/logs-tiny/checkpoints \
        --data_dir runs/training --preset tiny [--limit 64] [--json_out report.json] \
        [--device cpu]

Port of the root ``validate.py`` (without its ``--oracle``): the per-speaker
mel L1 is the quality metric BASELINE.json names.  A checkpoint (a file,
or a directory whose latest checkpoint is taken, as ``Synthesizer.load``
takes it) runs teacher-forced over every utterance of ``--data_dir`` in
metadata order, short last batches included (``Feeder(shuffle=False,
drop_remainder=False)``), with the BatchNorms on their running statistics
and no gradient.  The prenet's dropout stays on, as in the JAX package, its
masks drawn from a generator seeded 0 for every batch (the JAX package's
``PRNGKey(0)``).  Prints a JSON report: ``per_speaker`` {mel_l1, linear_l1,
frames} (frame-weighted means over the true frames of each utterance),
``overall`` and ``n_utterances``.  Runs on the CUDA device unless given
``--device cpu``.
"""

from __future__ import annotations

import argparse
import collections
import json

import numpy as np
import torch


def validate(syn, data_dir: str, limit: int | None = None) -> dict:
    """The report of ``syn``'s model over the corpus in ``data_dir``."""
    from .data.feeder import Feeder
    from .train_loop import batch_to_device
    cfg, model, dev = syn.cfg, syn.model, syn.device
    feeder = Feeder(data_dir, cfg, shuffle=False, drop_remainder=False)
    acc = collections.defaultdict(lambda: {"mel": 0.0, "lin": 0.0, "frames": 0})
    n_done = 0
    model.eval()
    for batch in feeder.epoch_batches(0):
        if limit is not None and n_done >= limit:
            break
        inputs, lengths, mels, _, _, sids = batch_to_device(batch, dev)
        with torch.no_grad():
            out = model(inputs, lengths, mels.float(),
                        speaker_ids=sids if cfg.model.num_speakers > 1 else None,
                        generator=torch.Generator(device=dev).manual_seed(0))
        mel_o = out.mel_outputs.cpu().numpy()
        lin_o = out.linear_outputs.cpu().numpy()
        mel_t = torch.as_tensor(batch.mel_targets).float().numpy()
        lin_t = torch.as_tensor(batch.linear_targets).float().numpy()
        for i in range(batch.batch_size):
            n = int(batch.target_lengths[i])
            a = acc[int(batch.speaker_ids[i])]
            a["mel"] += float(np.abs(mel_o[i, :n] - mel_t[i, :n]).mean()) * n
            a["lin"] += float(np.abs(lin_o[i, :n] - lin_t[i, :n]).mean()) * n
            a["frames"] += n
            n_done += 1
    report = {"per_speaker": {}, "n_utterances": n_done}
    tot_mel = tot_lin = tot_frames = 0.0
    for sid in sorted(acc):
        a = acc[sid]
        report["per_speaker"][str(sid)] = {"mel_l1": a["mel"] / max(a["frames"], 1),
                                           "linear_l1": a["lin"] / max(a["frames"], 1),
                                           "frames": a["frames"]}
        tot_mel += a["mel"]
        tot_lin += a["lin"]
        tot_frames += a["frames"]
    report["overall"] = {"mel_l1": tot_mel / max(tot_frames, 1),
                         "linear_l1": tot_lin / max(tot_frames, 1)}
    return report


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="python -m tacotron_multispeaker_torch.validate")
    p.add_argument("--checkpoint_dir", required=True)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--preset", default="single_speaker")
    p.add_argument("--hparams", default="")
    p.add_argument("--limit", type=int, default=None, help="max utterances (default: all)")
    p.add_argument("--json_out", default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device; cpu runs the plain "
                        "PyTorch path)")
    args = p.parse_args(argv)

    from .config import get_config
    from .synthesizer import Synthesizer
    cfg = get_config(args.preset, args.hparams)
    syn = Synthesizer(cfg, device=args.device).load(args.checkpoint_dir)
    report = validate(syn, args.data_dir, args.limit)
    out = json.dumps(report, indent=2)
    print(out)
    if args.json_out:
        with open(args.json_out, "w") as f:
            f.write(out)
    return report


if __name__ == "__main__":
    main()
