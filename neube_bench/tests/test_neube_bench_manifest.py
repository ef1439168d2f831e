"""BENCHMARK.json: its names, units and shape, and that every
configuration, traffic mix, driver and metric it names is found by name.

    python -m pytest neube_bench/tests -q
"""

import importlib
import json
import os
import re

from small import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    M = json.load(_f)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_size():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    assert 1 <= len(M["command"]) <= 32 and all(_line(w)
                                                 for w in M["command"])
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
        assert not p.rstrip("/").endswith("_torch")


def test_names_units_and_keys():
    names = []
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) \
            and _line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k)
                                               for k in c["reduced"])
        names.append(c["name"])
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        names.append(w["name"])
    for group, extra in (("end_to_end", {"bound"}),
                         ("per_layer", {"layer", "moves"})):
        for m in M[group]:
            keys = {"name", "unit", "better", "source"} | extra
            assert set(m) - {"workloads"} == keys
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            names.append(m["name"])
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
    assert len(names) == len(set(names))
    assert any(m["name"] == "setup_s" for m in M["end_to_end"])


def test_every_named_part_is_found():
    cells = {w["name"]: w for w in M["workloads"]}
    files = [c["file"] for c in M["configs"]]
    assert len(files) == len(set(files))
    for c in M["configs"]:
        assert c["file"].startswith(tuple(p.rstrip("/") + "/"
                                          for p in M["paths"]))
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]
        assert any(w["config"] == c["name"] for w in M["workloads"])
    for w in cells.values():
        assert any(c["name"] == w["config"] for c in M["configs"])
        with open(os.path.join(ROOT, "neube_bench", "traffic",
                               w["traffic"] + ".json")) as f:
            traffic = json.load(f)
        importlib.import_module("neube_bench.drivers." + traffic["driver"])
        assert traffic["limits"]
    e2e = {m["name"]: m for m in M["end_to_end"]}
    for m in M["end_to_end"] + M["per_layer"]:
        assert os.path.isfile(os.path.join(ROOT, "neube_bench", "metrics",
                                           m["name"] + ".py"))
        for w in m.get("workloads", []):
            assert w in cells
    for m in M["per_layer"]:
        moved = e2e[m["moves"]]
        for w in m.get("workloads", list(cells)):
            assert "workloads" not in moved or w in moved["workloads"]
    for w in cells:
        reported = [m for m in M["end_to_end"]
                    if "workloads" not in m or w in m["workloads"]]
        assert len(reported) >= 2
        assert any("workloads" not in m or w in m["workloads"]
                   for m in M["per_layer"])
