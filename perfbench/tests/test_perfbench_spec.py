"""BENCHMARK.json against the benchmark's contract, and the files it
names."""

import json
import os
import re

import pytest

from perfbench.spec import HERE, ROOT, Spec

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.fullmatch(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
        assert os.path.isdir(os.path.join(ROOT, p))
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32
    for word in cmd:
        assert 1 <= len(word) <= 200 and "\n" not in word
        assert not word.startswith("/") and ".." not in word
    assert cmd[1].startswith(BENCH["paths"][0] + "/")


def test_run_seconds_fits_a_full_check():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def _names(kind):
    return [x["name"] for x in BENCH[kind]]


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_are_plain_and_unique(kind):
    names = _names(kind)
    assert names and len(names) == len(set(names))
    for n in names:
        assert NAME.fullmatch(n), n
    metric_names = _names("end_to_end") + _names("per_layer")
    assert len(metric_names) == len(set(metric_names))


def test_configs_and_their_files():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["source"].startswith("https://") and len(c["source"]) <= 200
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        assert c["file"] not in files
        files.add(c["file"])
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert cfg["source"] == c["source"]
        assert os.path.exists(os.path.join(HERE, "entries",
                                           cfg["entry"] + ".py"))


def test_workloads():
    configs = _names("configs")
    pairs = set()
    four = 0
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and NAME.fullmatch(w["traffic"])
        assert w["chips"] in (1, 4)
        four += w["chips"] == 4
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        traffic = json.load(open(os.path.join(HERE, "traffic",
                                              w["traffic"] + ".json")))
        assert os.path.exists(os.path.join(
            HERE, "generators", traffic["generator"] + ".py"))
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_metrics():
    cells = _names("workloads")
    e2e = _names("end_to_end")
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        limit = 0.25
        assert 0.01 <= m["bound"] <= limit
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower",
                                                             "higher")
        assert os.path.exists(os.path.join(HERE, "metrics",
                                           m["name"] + ".py"))
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_reports_enough(cell):
    spec = Spec(cell)
    e2e = [m["name"] for m in spec.metrics("end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.metrics("per_layer")
    for m in spec.metrics("per_layer"):
        assert m["moves"] in e2e
