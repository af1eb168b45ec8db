"""What every run shares: the manifest, the cell's files, the device check,
the weights drawn from the seed, and the result line."""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
from dataclasses import asdict, dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that may not be loaded in a run (compared whole)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "tacotron_multispeaker_tpu",
                     "chip_smoke")


class NoDevice(RuntimeError):
    """The machine lacks the CUDA devices the cell asks for."""


@dataclass
class Cell:
    """One entry of ``BENCHMARK.json``'s workloads with its files loaded."""
    name: str
    chips: int
    config: dict          # configs/<config>.json
    traffic: dict         # traffic/mixes/<traffic>.json
    limits: dict          # limits/<cell>.json: {number: limit}
    per_layer: list = field(default_factory=list)    # manifest entries for this cell
    end_to_end: list = field(default_factory=list)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str) -> Cell:
    man = manifest()
    entry = next((w for w in man["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg = next(c for c in man["configs"] if c["name"] == entry["config"])
    return Cell(name=name, chips=entry["chips"], config=load_json(ROOT / cfg["file"]),
                traffic=load_json(HERE / "traffic" / "mixes" / f"{entry['traffic']}.json"),
                limits=load_json(HERE / "limits" / f"{name}.json"),
                per_layer=[m for m in man["per_layer"] if _reports(m, name)],
                end_to_end=[m for m in man["end_to_end"] if _reports(m, name)])


class ConfigMismatch(RuntimeError):
    """The port's configuration differs from what the configuration file states."""


def split_overrides(overrides: str) -> list[tuple[str, str]]:
    """``section.key=value,...`` → [(section.key, value)]; commas inside
    brackets belong to the value."""
    pairs, depth, cur = [], 0, ""
    for ch in overrides + ",":
        depth += (ch in "([") - (ch in ")]")
        if ch == "," and depth == 0:
            if cur.strip():
                key, _, value = cur.partition("=")
                pairs.append((key.strip(), value.strip()))
            cur = ""
        else:
            cur += ch
    return pairs


def _coerce(current, raw: str):
    if isinstance(current, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(current, (int, float)):
        return type(current)(raw)
    if isinstance(current, list):
        elem = type(current[0]) if current else int
        return [elem(x.strip()) for x in raw.strip("()[] ").split(",") if x.strip()]
    return raw


def resolve(config: dict, extra: str | None = None) -> dict:
    """The configuration as run: the file's ``resolved`` settings with a
    mix's ``section.key=value`` overrides applied.  The reference and the
    counts read their sizes from this, never from the port."""
    dims = json.loads(json.dumps(config["resolved"]))
    for key, raw in split_overrides(extra or ""):
        section, _, leaf = key.partition(".")
        if leaf not in dims.get(section, {}):
            raise ConfigMismatch(f"override {key!r} names no setting of the configuration")
        dims[section][leaf] = _coerce(dims[section][leaf], raw)
    return dims


def differences(stated: dict, port: dict, at: str = "") -> list[str]:
    """Every setting the file states that the port lacks or sets otherwise
    (settings the port has beyond them are its own)."""
    out = []
    for k, v in stated.items():
        name = f"{at}{k}"
        if k not in port:
            out.append(f"{name}: missing in the port")
        elif isinstance(v, dict) and isinstance(port[k], dict):
            out += differences(v, port[k], name + ".")
        elif v != port[k]:
            out.append(f"{name}: file {v!r}, port {port[k]!r}")
    return out


def port_config(config: dict, extra: str | None = None):
    """The port's ``Config`` for a configuration file (preset + overrides),
    held against the file's ``resolved`` settings: a preset that no longer
    gives what the file states raises :class:`ConfigMismatch`."""
    from tacotron_multispeaker_torch.config import get_config
    overrides = ",".join(s for s in (config.get("overrides", ""), extra or "") if s)
    cfg = get_config(config["preset"], overrides or None)
    port = json.loads(json.dumps(asdict(cfg)))
    diff = differences(resolve(config, extra), port)
    if diff:
        raise ConfigMismatch(f"the port's preset {config['preset']!r} differs from "
                             f"configuration {config.get('name')!r}: " + "; ".join(diff))
    return cfg


def require_devices(n: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is false: this benchmark runs on "
                       "CUDA devices only")
    if torch.cuda.device_count() < n:
        raise NoDevice(f"the cell needs {n} CUDA devices, the machine has "
                       f"{torch.cuda.device_count()}")


def set_cache_dirs() -> None:
    """Keep every kernel and build cache at a fixed path inside the checkout,
    so only a checkout's first run builds.  The port builds its kernel
    libraries into its own ``build/`` directory, also inside the checkout."""
    cache = ROOT / ".bench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))


def forbidden_loaded() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def load_by_path(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- weights ------------------------------------------------------------------

def draw_weights(shapes: dict, seed: int, device, fixed: dict | None = None) -> dict:
    """{name: f32 tensor} for the port's ``state_dict`` names and shapes,
    drawn on ``device`` from ``seed`` in one call: matrices, convolution
    kernels, embeddings and the attention vector normal with std
    1/sqrt(fan in) (lecun normal); biases normal with std 0.1; BatchNorm
    scale 1, shift 0, running mean 0 and variance 1.  ``fixed`` sets named
    leaves to a constant instead (a configuration's ``serve_weights``: the
    level of the spectrogram the model emits)."""
    import torch
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    bn = {n.rsplit(".", 1)[0] for n in names if n.endswith(".mean")}
    out, at = {}, 0
    for n, size in zip(names, sizes):
        t = flat[at: at + size].view(shapes[n])
        at += size
        prefix, leaf = n.rsplit(".", 1)
        if prefix in bn:
            fill = {"scale": 1.0, "var": 1.0}.get(leaf, 0.0)
            out[n] = torch.full(shapes[n], fill, device=device)
        elif fixed and n in fixed:
            out[n] = torch.full(shapes[n], float(fixed[n]), device=device)
        elif len(shapes[n]) == 1 and leaf != "v":
            out[n] = t * 0.1
        else:
            fan_in = shapes[n][-1] if len(shapes[n]) == 1 else size // shapes[n][0]
            out[n] = t / math.sqrt(fan_in)
    return out


def shapes_of(module) -> dict:
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


# -- the result line ------------------------------------------------------------

def device_info(n: int, peak: int) -> dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": n,
            "memory_peak_bytes": int(peak)}


def print_checks(checks: list) -> None:
    """Each compared number beside its limit, as the last lines on stderr."""
    for name, value, limit in checks:
        ok = "ok" if value <= limit else "FAIL"
        print(f"check {name} = {value!r} limit {limit!r} {ok}", file=sys.stderr)


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks: list, breakdown: dict | None = None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    return json.dumps(out)
