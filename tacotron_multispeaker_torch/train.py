"""Training entry point of the port.

    python -m tacotron_multispeaker_torch.train --base_dir ./runs --preset tiny \
        [--hparams train.batch_size=8] [--max_steps 1000] [--name myrun] [--device cpu] \
        [--pipeline grain --pipeline_workers 4]

Trains on ``<base_dir>/<input>`` (a corpus written by
``python -m tacotron_multispeaker_torch.preprocess`` or by the JAX
package's ``preprocess.py``) into ``<base_dir>/logs-<name>``, resuming from
the latest checkpoint there.  Runs on the CUDA device unless given
``--device cpu``; the flags are the root ``train.py``'s, with ``--device``
for ``--platform``.

Sharded training runs one process per rank of a (data, model) mesh built
from ``cfg.parallel`` (``parallel.model_parallel_size`` ranks on the model
axis, the rest on the data axis):

    torchrun --standalone --nproc_per_node 4 -m tacotron_multispeaker_torch.train \
        --base_dir ./runs --preset multispeaker_vctk [--device cpu]

joins the process group from torchrun's variables: NCCL where every rank
has a card of its own, gloo where ranks share a card or, with ``--device
cpu``, run on the CPU.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="python -m tacotron_multispeaker_torch.train")
    p.add_argument("--base_dir", default="./runs")
    p.add_argument("--input", default="training")
    p.add_argument("--preset", default="single_speaker")
    p.add_argument("--name", default=None, help="run name (default: preset)")
    p.add_argument("--hparams", default="")
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--no_restore", action="store_true")
    p.add_argument("--profile", default=None, metavar="START:STOP",
                   help="trace steps [START, STOP) with torch.profiler")
    p.add_argument("--cmudict_path", default=None,
                   help="cmudict-0.7b file for pronunciation augmentation "
                        "(enable with train.cmudict_prob>0)")
    p.add_argument("--pipeline", default="feeder", choices=["feeder", "grain"],
                   help="input pipeline: the Feeder on a prefetch thread, or worker "
                        "processes over the same global batch plan")
    p.add_argument("--pipeline_workers", type=int, default=0,
                   help="grain worker processes (0 = in-process)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device; cpu runs the plain "
                        "PyTorch path)")
    args = p.parse_args(argv)

    from .config import get_config
    from .parallel import distributed
    from .train_loop import train
    cfg = get_config(args.preset, args.hparams)
    run_name = args.name or cfg.name
    profile_steps = None
    if args.profile:
        a, _, b = args.profile.partition(":")
        profile_steps = (int(a), int(b))
    device = distributed.initialize_distributed(device=args.device)
    try:
        return train(os.path.join(args.base_dir, f"logs-{run_name}"),
                     os.path.join(args.base_dir, args.input), cfg, max_steps=args.max_steps,
                     restore=not args.no_restore, profile_steps=profile_steps,
                     cmudict_path=args.cmudict_path, pipeline=args.pipeline,
                     pipeline_workers=args.pipeline_workers, device=device)
    finally:
        distributed.destroy()


if __name__ == "__main__":
    main()
