"""The port's train loop on two gloo CPU ranks, ``tiny`` preset.

``train_loop.train`` in a process group of two ranks (``parallel.run_ranks``),
data-parallel (mesh (2, 1)) and hybrid (mesh (1, 2), the speaker table's
rows sharded over the model axis): finite losses, the same on both ranks;
checkpoints in the single-process layout, written by rank 0, with the full
speaker table and its full Adam moments; rank 0's eval artifacts; a resume
on two ranks, then on one process, and ``Synthesizer.load`` of the hybrid
run's checkpoint; and the entry point under ``torchrun``.  The rank function
sits at the top of this module, which imports nothing of JAX.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tacotron_multispeaker_torch import config as tconfig
from tacotron_multispeaker_torch import preprocess as preprocess_main
from tacotron_multispeaker_torch import train_loop
from tacotron_multispeaker_torch.parallel import run_ranks
from tacotron_multispeaker_torch.synthesizer import Synthesizer
from tacotron_multispeaker_torch.utils.checkpoint import CheckpointManager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one input and one output bucket, 4 speakers, a checkpoint every 2 steps
OV = ("model.num_speakers=4,model.max_iters=8,train.batch_size=4,"
      "train.batches_per_group=2,train.summary_interval=1,train.checkpoint_interval=2,"
      "train.input_bucket_boundaries=(64),train.bucket_boundaries=(200)")
# the table's 4 rows over a model axis of 2
HYBRID = OV + ",parallel.model_parallel_size=2,parallel.shard_speaker_table_min=2"


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A 12-utterance, 4-speaker synthetic corpus preprocessed by the port's
    entry point on the CPU: the data dir."""
    base = str(tmp_path_factory.mktemp("ploop"))
    path = preprocess_main.main(["--dataset", "synthetic", "--base_dir", base, "--preset",
                                 "tiny", "--n_utts", "12", "--n_speakers", "4",
                                 "--device", "cpu"])
    return os.path.dirname(path)


def _rank_train(rank, log_dir, data_dir, overrides, max_steps):
    """``train_loop.train`` on this rank; its result without the step times."""
    cfg = tconfig.get_config("tiny", overrides)
    out = train_loop.train(log_dir, data_dir, cfg, max_steps=max_steps, device="cpu")
    return {k: v for k, v in out.items() if k != "step_seconds"}


def _metrics(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _initial_state(overrides):
    """The single-process state the loop starts from (its seed)."""
    from tacotron_multispeaker_torch import training
    cfg = tconfig.get_config("tiny", overrides)
    return training.create_train_state(cfg, cfg.train.seed, device="cpu")[1]


def _check_ranks(outs, steps):
    """Both ranks' results equal (the loss is all-reduced) and finite."""
    assert [o["step"] for o in outs] == [steps, steps]
    assert outs[0] == outs[1]
    assert all(np.isfinite(v) for v in outs[0].values())


def _check_checkpoint(log_dir, steps, ckpt_steps):
    """The checkpoints of ``ckpt_steps`` and nothing else; the one of
    ``steps`` in the single-process layout with the full speaker table and
    its full Adam moments.  Returns it."""
    ckpts = CheckpointManager(os.path.join(log_dir, "checkpoints"))
    assert sorted(os.listdir(ckpts.directory)) == [f"ckpt-{s:08d}.pt" for s in ckpt_steps]
    saved = torch.load(ckpts.path(steps), weights_only=True)
    assert sorted(saved) == ["model", "optimizer", "seed", "step"] and saved["step"] == steps
    state = _initial_state(OV)
    table = saved["model"]["speaker_table.weight"]
    assert table.shape == state.model.speaker_table.weight.shape and table.shape[0] == 4
    key = [n for n, _ in state.model.named_parameters()].index("speaker_table.weight")
    moments = saved["optimizer"]["state"][key]
    assert moments["exp_avg"].shape == moments["exp_avg_sq"].shape == table.shape
    assert int(moments["step"]) == steps
    return saved


def _eval_written(log_dir, step):
    assert os.path.getsize(os.path.join(log_dir, f"step-{step}-audio.wav")) > 44
    assert np.load(os.path.join(log_dir, f"step-{step}-align.npy")).shape[0] == 8
    assert f"wrote eval artifacts for step {step}" in open(
        os.path.join(log_dir, "train.log")).read()


def test_data_parallel_loop_checkpoints_eval_and_resume(corpus, tmp_path):
    log_dir = str(tmp_path / "dp")
    outs = run_ranks(_rank_train, 2, log_dir, corpus, OV, 4, device="cpu", timeout=300)
    _check_ranks(outs, 4)
    _check_checkpoint(log_dir, 4, [2, 4])
    for step in (2, 4):
        _eval_written(log_dir, step)
    assert "data_parallel step, each rank loads 1/2 of every batch" in open(
        os.path.join(log_dir, "train.log")).read()
    assert [r["step"] for r in _metrics(log_dir)] == [1, 2, 3, 4]
    # resume on two ranks: steps 5 and 6, a checkpoint at 6
    outs = run_ranks(_rank_train, 2, log_dir, corpus, OV, 6, device="cpu", timeout=300)
    _check_ranks(outs, 6)
    _check_checkpoint(log_dir, 6, [2, 4, 6])
    assert [r["step"] for r in _metrics(log_dir)] == [1, 2, 3, 4, 5, 6]
    assert "resumed from checkpoint at step 4" in open(os.path.join(log_dir, "train.log")).read()


def test_hybrid_loop_checkpoint_resumes_sharded_single_and_in_synthesizer(corpus, tmp_path):
    log_dir = str(tmp_path / "hybrid")
    outs = run_ranks(_rank_train, 2, log_dir, corpus, HYBRID, 4, device="cpu", timeout=300)
    _check_ranks(outs, 4)
    first = _check_checkpoint(log_dir, 4, [2, 4])
    _eval_written(log_dir, 4)
    assert "hybrid step, each rank loads 1/2 of every batch" in open(
        os.path.join(log_dir, "train.log")).read()
    # rows of both shards learned (moved from the loop's initial table)
    init = _initial_state(HYBRID).model.speaker_table.weight.detach()
    moved = (first["model"]["speaker_table.weight"] - init).abs().amax(-1) > 0
    assert moved[:2].any() and moved[2:].any()
    # resume on two ranks to 6, then on one process to 7 (a mesh of one)
    outs = run_ranks(_rank_train, 2, log_dir, corpus, HYBRID, 6, device="cpu", timeout=300)
    _check_ranks(outs, 6)
    _check_checkpoint(log_dir, 6, [2, 4, 6])
    out = train_loop.train(log_dir, corpus, tconfig.get_config("tiny", HYBRID), max_steps=7,
                           device="cpu")
    assert out["step"] == 7 and np.isfinite(out["loss"])
    saved = _check_checkpoint(log_dir, 7, [2, 4, 6, 7])
    assert [r["step"] for r in _metrics(log_dir)] == list(range(1, 8))
    # the sharded run's checkpoint loads into a Synthesizer unchanged
    syn = Synthesizer(tconfig.get_config("tiny", HYBRID), device="cpu").load(
        os.path.join(log_dir, "checkpoints"))
    assert all(torch.equal(v, saved["model"][k]) for k, v in syn.model.state_dict().items())


def test_train_entry_point_under_torchrun(corpus, tmp_path):
    base = os.path.dirname(corpus)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         "2", "-m", "tacotron_multispeaker_torch.train", "--base_dir", base, "--preset",
         "tiny", "--name", "torchrun", "--max_steps", "2", "--device", "cpu", "--hparams",
         HYBRID], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    logs = os.path.join(base, "logs-torchrun")
    assert CheckpointManager(os.path.join(logs, "checkpoints")).steps() == [2]
    assert [r["step"] for r in _metrics(logs)] == [1, 2]
    text = open(os.path.join(logs, "train.log")).read()
    assert "mesh (1, 2), gloo: hybrid step" in text and "wrote eval artifacts for step 2" in text
