"""Weight bridge between the JAX package's flax variables and the port.

The flax tree ``{"params": ..., "batch_stats": ...}`` is given as nested
dicts of numpy arrays.  The port's modules carry the flax names (module
path ``encoder.cbhg.bigru.fwd.cell.xg`` ↔ ``encoder/cbhg/bigru/fwd/cell/xg``),
so each leaf maps by its path; only layouts differ:

=====================  =========================  ==========================
layer                  flax leaf                   port tensor
=====================  =========================  ==========================
Dense                  kernel [in, out], bias      weight [out, in], bias
Conv (ConvBN)          kernel WIO [K, in, out]     weight [out, in, K]
ConvBank               kernel [K, in, K*C]         weight [K*C, in, K]
                       (unmasked; masked at run time on both sides)
Embed                  embedding [N, E]            weight [N, E]
BatchNorm              params scale/bias,          scale, bias, mean, var
                       batch_stats mean/var
attention ``v``        [A, 1]                      [A]
location ``loc_conv``  kernel WIO [W, 1, filters]  weight [filters, 1, W]
location ``b``         [] (score bias)             0-d tensor
=====================  =========================  ==========================

Both directions are exact (transposes and reshapes only).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .models.attention import BahdanauAttention, LocationSensitiveAttention
from .models.modules import BatchNorm, ConvBank


def _leaf_rules(model: nn.Module):
    """Yield (port key, flax collection, flax path, to_port, to_flax)."""
    to_lin = lambda a: a.T
    wio_to_oik = lambda a: np.transpose(a, (2, 1, 0))
    for prefix, mod in model.named_modules():
        path = prefix.split(".") if prefix else []
        own = dict(mod.named_parameters(recurse=False))
        own.update(dict(mod.named_buffers(recurse=False)))
        own = {k: v for k, v in own.items()
               if k not in mod._non_persistent_buffers_set}
        for name in own:
            key = ".".join(path + [name])
            if isinstance(mod, nn.Linear) and name == "weight":
                yield key, "params", path + ["kernel"], to_lin, to_lin
            elif isinstance(mod, (nn.Conv1d, ConvBank)) and name == "weight":
                yield key, "params", path + ["kernel"], wio_to_oik, wio_to_oik
            elif isinstance(mod, nn.Embedding) and name == "weight":
                yield key, "params", path + ["embedding"], None, None
            elif isinstance(mod, BatchNorm) and name in ("mean", "var"):
                yield key, "batch_stats", path + [name], None, None
            elif isinstance(mod, BahdanauAttention) and name == "v":
                yield (key, "params", path + ["v"], lambda a: a.reshape(-1),
                       lambda a: a.reshape(-1, 1))
            elif isinstance(mod, LocationSensitiveAttention) and name == "b":
                yield key, "params", path + ["b"], None, None
            elif name in ("bias", "scale"):
                yield key, "params", path + [name], None, None
            else:
                raise KeyError(f"no flax mapping for port tensor {key!r} "
                               f"({type(mod).__name__})")


def flax_to_state_dict(variables, model: nn.Module,
                       shards: dict[str, slice] | None = None) -> dict[str, torch.Tensor]:
    """Flax variables (numpy tree) → a full ``state_dict`` for ``model``.

    ``shards`` (parallel.mesh.param_shards): port tensor name → the rows
    (dim 0) a rank of a mesh keeps; those tensors take only these rows of
    their flax leaf, as ``P("model", None)`` cuts the speaker table.
    Raises if a port tensor has no flax leaf, if a flax leaf is left over,
    or if a shape disagrees."""
    used = set()
    state = {}
    expected = model.state_dict()
    for key, coll, path, to_port, _ in _leaf_rules(model):
        node = variables[coll]
        for p in path:
            node = node[p]
        arr = np.asarray(node)
        arr = to_port(arr) if to_port is not None else arr
        if shards and key in shards:
            arr = arr[shards[key]]
        t = torch.tensor(np.array(arr, order="C"))
        if tuple(t.shape) != tuple(expected[key].shape):
            raise ValueError(f"{key}: flax {'/'.join(path)} gives shape "
                             f"{tuple(t.shape)}, port has {tuple(expected[key].shape)}")
        state[key] = t.to(expected[key].dtype)
        used.add((coll, tuple(path)))
    leftover = sorted("/".join((c,) + p) for c, p in _flax_leaves(variables)
                      if (c, p) not in used)
    if leftover:
        raise KeyError(f"flax leaves with no port tensor: {leftover[:8]}")
    missing = set(expected) - set(state)
    if missing:
        raise KeyError(f"port tensors left unset: {sorted(missing)[:8]}")
    return state


def state_dict_to_flax(state: dict[str, torch.Tensor], model: nn.Module):
    """A port ``state_dict`` → flax variables (nested dicts of numpy)."""
    out = {"params": {}, "batch_stats": {}}
    for key, coll, path, _, to_flax in _leaf_rules(model):
        arr = state[key].detach().cpu().numpy()
        arr = to_flax(arr) if to_flax is not None else arr
        node = out[coll]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.array(arr, order="C")
    return out


def grads_to_flax(model: nn.Module):
    """The parameters' ``.grad`` in the flax ``params`` layout (nested dicts
    of numpy), the tree ``jax.grad`` gives for ``params``; a parameter
    without a gradient counts as zeros."""
    params = dict(model.named_parameters())
    out = {}
    for key, coll, path, _, to_flax in _leaf_rules(model):
        if coll != "params":
            continue
        g = params[key].grad
        arr = (np.zeros(tuple(params[key].shape), np.float32) if g is None
               else g.detach().float().cpu().numpy())
        arr = to_flax(arr) if to_flax is not None else arr
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.array(arr, order="C")
    return out


def _flax_leaves(tree, prefix=()):
    """(collection, path) of every leaf of a nested-dict flax tree."""
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flax_leaves(v, prefix + (k,))
        else:
            full = prefix + (k,)
            yield full[0], full[1:]
