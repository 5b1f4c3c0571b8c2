"""BENCHMARK.json against the benchmark's contract, and every name in it
resolved to its files."""
import json
import os
import re

import pytest

from pbench import spec
import tiny

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert all(_line(w) for w in BENCH["command"])
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p
        assert os.path.isdir(os.path.join(spec.ROOT, p))
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024


def test_entries_have_just_their_keys_and_valid_names():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in BENCH[k]}) == len(BENCH[k])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
               for m in metrics)


def test_every_cell_reports_what_the_contract_asks():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for w in BENCH["workloads"]:
        cell = spec.resolve(w["name"])
        mine = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in mine and len(mine) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in mine
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            assert w in {x["name"] for x in BENCH["workloads"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)


@pytest.mark.parametrize("workload",
                         [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_to_its_files(workload):
    from svt_av1_tpu_torch.api.config import EncoderConfig
    cell = spec.resolve(workload)
    EncoderConfig(**cell.config["encoder"]).validate()
    assert cell.traffic["entry"] in ("send_pictures", "send_picture")
    assert set(cell.limits["limits"]) == {"missing_frames", "decode_errors",
                                          "mismatch_px", "mean_shift_y",
                                          "mse_y_worst"}
    assert set(cell.readers) == {m["name"] for m in cell.per_layer}
    assert all(callable(r) for r in cell.readers.values())


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_file_states_its_entry(config):
    entry = {c["name"]: c for c in BENCH["configs"]}[config]
    assert entry["file"].startswith(BENCH["paths"][0] + "/")
    with open(os.path.join(spec.ROOT, entry["file"])) as f:
        data = json.load(f)
    assert data["name"] == config
    assert data["source"] == entry["source"]
    assert data["reduced"] == entry["reduced"]
    assert all(k in data["encoder"] for k in entry["reduced"])


def test_a_cell_added_as_files_is_found_without_an_edit(tmp_path):
    root = tiny.make(tmp_path)
    for name, (cfg, traffic) in tiny.TINY_CELLS.items():
        cell = spec.resolve(name, root=root)
        assert cell.config_name == cfg and cell.traffic_name == traffic
        assert cell.config["encoder"] == tiny.TINY_CONFIGS[cfg]
        assert {m["name"] for m in cell.per_layer} == {
            m["name"] for m in BENCH["per_layer"] if "workloads" not in m}
    with pytest.raises(KeyError):
        spec.resolve("tiny.ai")     # not in the checkout's own file
