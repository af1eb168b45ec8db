#!/usr/bin/env python3
"""Where the f32 data-parallel step on the card departs from one process.

    python3 tools/sharded_relu_flips.py [RANKS ...]

Runs ``chip_smoke.py`` phase 9's f32 data-parallel check case
(``multispeaker_vctk``, dropout off, cross-replica BatchNorm, B=8, L=23,
T=40, seed 6) in one process on the card and on each mesh (RANKS, 1)
(default 4 and 2) of ranks sharing the card, and prints for each mesh:
every ReLU'd ConvBN's pre-activation against the one process's (the
largest difference, the positions whose sign differs and their
magnitude) and the whole gradient's relative L2 distance.  A sign that
differs moves one position's gradient in or out of that conv and
everything upstream.  Needs a CUDA device.
"""

import os
import sys

import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as c  # noqa: E402
from tacotron_multispeaker_torch import training  # noqa: E402
from tacotron_multispeaker_torch.config import get_config  # noqa: E402
from tacotron_multispeaker_torch.models.modules import ConvBN, _same_pad  # noqa: E402
from tacotron_multispeaker_torch.parallel import make_mesh, run_ranks  # noqa: E402

B = 8
OVERRIDES = f"{c.PAR_CHECK_OV},train.batch_size={B}"


def capture(model):
    """{ConvBN name: its conv's pre-activation [B, T, C]} of the next pass."""
    seen = {}
    for name, mod in model.named_modules():
        if isinstance(mod, ConvBN) and mod.activation:
            def hook(m, inp, _out, name=name):
                xp = F.pad(inp[0].to(m.compute_dtype).transpose(1, 2),
                           _same_pad(m.conv.kernel_size[0]))
                seen[name] = F.conv1d(xp, m.conv.weight, m.conv.bias).transpose(1, 2).cpu()
            mod.register_forward_hook(hook)
    return seen


def one_step(model, state, step, batch, device):
    seen = capture(model)
    step(state, *(a.to(device) for a in batch))
    return seen, {k: p.grad.cpu() for k, p in model.named_parameters()}


def rank(rank, batch, n_data):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("multispeaker_vctk", OVERRIDES)
    mesh = make_mesh(cfg.parallel, data=n_data, model=1)
    model, state = training.create_train_state(cfg, seed=1, mesh=mesh)
    n = B // n_data
    return one_step(model, state, training.make_sharded_train_step(cfg, model, mesh),
                    [a[rank * n:(rank + 1) * n] for a in batch], mesh.device)


def main():
    c.phase_build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("multispeaker_vctk", OVERRIDES)
    batch = c._train_batch(cfg, B, c.PAR_CHECK_L, c.PAR_CHECK_T, seed=6, device="cpu")
    model, state = training.create_train_state(cfg, seed=1)
    ref, g_ref = one_step(model, state, training.make_train_step(cfg, model), batch, "cuda")
    square = lambda d: sum((t.double() ** 2).sum().item() for t in d.values())
    for n_data in [int(a) for a in sys.argv[1:]] or [4, 2]:
        outs = run_ranks(rank, n_data, batch, n_data, timeout=600)
        for name, want in ref.items():
            got = torch.cat([o[0][name] for o in outs])
            flip = (got > 0) != (want > 0)
            print(f"({n_data}, 1) {name}: pre-activation max|diff| "
                  f"{(got - want).abs().max().item():.3e}, {int(flip.sum())} ReLU sign(s) "
                  f"differ, |pre| there {want[flip].abs().tolist()[:8]}", flush=True)
        g = outs[0][1]
        l2 = (square({k: g[k] - t for k, t in g_ref.items()}) / square(g_ref)) ** 0.5
        print(f"({n_data}, 1): gradient relative L2 distance {l2:.3e}", flush=True)


if __name__ == "__main__":
    main()
