"""BENCHMARK.json and the files it names."""

import math
import re

import pytest

from benchmark import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = core.manifest()
E2E = {m["name"]: m for m in MAN["end_to_end"]}


def reporting(metric, cells):
    return metric.get("workloads", [c["name"] for c in cells])


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= MAN["run_seconds"] <= 51


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(section):
    names = [e["name"] for e in MAN[section]]
    assert len(names) == len(set(names))
    for e in MAN[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]


def test_moves_reported_in_each_cell():
    cells = MAN["workloads"]
    for m in MAN["per_layer"]:
        e2e = E2E[m["moves"]]
        for cell in reporting(m, cells):
            assert cell in reporting(e2e, cells), (m["name"], cell)


def test_every_cell_reports_enough():
    cells = MAN["workloads"]
    for c in cells:
        e2e = [m for m in MAN["end_to_end"] if c["name"] in reporting(m, cells)]
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
        assert any(c["name"] in reporting(m, cells) for m in MAN["per_layer"])


def test_four_chip_cells_and_budget():
    cells = MAN["workloads"]
    four = sum(c["chips"] == 4 for c in cells)
    assert four <= max(1, math.floor(0.25 * len(cells)))
    assert all(c["chips"] in (1, 4) for c in cells)
    runs = 2 + 14 * 24
    assert runs * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_bounds():
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", [c["name"] for c in MAN["workloads"]])
def test_cell_files_found_by_name(cell):
    c = core.load_cell(cell)
    assert (core.HERE / "drivers" / f"{c.traffic['driver']}.py").exists()
    for m in c.per_layer:
        reader = core.load_by_path(core.HERE / "metrics" / f"{m['name']}.py", "m")
        assert callable(reader.read)
    assert set(c.limits) and all(v > 0 for v in c.limits.values())
    cfg = core.port_config(c.config)
    assert cfg.name == c.config["preset"]


@pytest.mark.parametrize("config", [c["name"] for c in MAN["configs"]])
def test_config_files(config):
    entry = next(c for c in MAN["configs"] if c["name"] == config)
    data = core.load_json(core.ROOT / entry["file"])
    assert data["name"] == config and data["reduced"] == entry["reduced"]
    assert set(data["resolved"]) == {"audio", "model", "train", "parallel", "cleaners", "name"}
    cfg = core.port_config(data)            # raises where the preset moved
    assert cfg.name == data["preset"]


def test_resolve_applies_mix_overrides():
    data = core.load_json(core.HERE / "configs" / "multispeaker_vctk.json")
    dims = core.resolve(data, "parallel.use_pallas=false,train.bucket_boundaries=(250,500)")
    assert dims["parallel"]["use_pallas"] is False
    assert dims["train"]["bucket_boundaries"] == [250, 500]
    assert data["resolved"]["parallel"]["use_pallas"] is True
    with pytest.raises(core.ConfigMismatch):
        core.resolve(data, "audio.no_such_setting=1")


@pytest.mark.parametrize("section,key,value", [
    ("audio", "griffin_lim_iters", 8), ("audio", "gl_momentum", 0.0),
    ("audio", "gl_method", "dft_bf16"), ("model", "compute_dtype", "float32"),
    ("model", "outputs_per_step", 2), ("train", "adam_eps", 1e-8)])
def test_changed_setting_is_refused(section, key, value):
    data = core.load_json(core.HERE / "configs" / "multispeaker_vctk.json")
    data["resolved"][section][key] = value
    with pytest.raises(core.ConfigMismatch, match=key):
        core.port_config(data)


def test_settings_the_port_lacks_are_refused():
    data = core.load_json(core.HERE / "configs" / "pod_synthesis.json")
    data["resolved"]["audio"]["gl_new_setting"] = 1
    assert core.differences(data["resolved"], data["resolved"] | {"extra": 1}) == []
    with pytest.raises(core.ConfigMismatch, match="gl_new_setting: missing"):
        core.port_config(data)


@pytest.mark.parametrize("path", sorted((core.HERE / "metrics").glob("*.py")),
                         ids=lambda p: p.stem)
def test_metric_readers_load(path):
    # the train cell's readers too, which no entry names yet
    assert callable(core.load_by_path(path, "reader_" + path.stem.replace(".", "_")).read)
