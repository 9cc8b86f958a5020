"""BENCHMARK.json against the manifest's rules: names, units and
lines within the allowed characters, every entry's file present, every
metric's reader found by its name, every cell reporting set-up, another
end-to-end metric and a per-layer one."""

import json
import re

from benchmark.tests.tiny import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def _m():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_keys_names_and_units():
    m = _m()
    assert set(m) == KEYS
    assert 1 <= m["run_seconds"] <= 51
    assert len(m["command"]) <= 32 and all(_line(w) for w in m["command"])
    names = []
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith(m["paths"][0] + "/")
        names.append(c["name"])
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _line(w["why"])
        names.append(w["name"])
    for e in m["end_to_end"] + m["per_layer"]:
        assert NAME.match(e["name"]) and UNIT.match(e["unit"])
        assert e["better"] in ("lower", "higher")
        names.append(e["name"])
    assert len(names) == len(set(names))
    for e in m["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    for e in m["per_layer"]:
        assert e["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(e["layer"])
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_files_and_readers_exist():
    from benchmark import harness
    m = _m()
    bench = REPO / m["paths"][0]
    for c in m["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert {"token_gap", "audio_lsb"} <= set(cfg["limits"])
    for w in m["workloads"]:
        t = json.loads((bench / "traffic" / f"{w['traffic']}.json")
                       .read_text())
        assert (bench / "traffic" / "kinds" / f"{t['kind']}.py").exists()
    e2e = {e["name"] for e in m["end_to_end"]}
    for e in m["end_to_end"] + m["per_layer"]:
        mod = harness.metric_module(bench, e["name"])
        assert mod.UNIT == e["unit"] and callable(mod.read)
        assert e.get("moves", e["name"]) in e2e


def test_every_cell_reports_what_it_must():
    m = _m()
    for w in m["workloads"]:
        def has(e):
            return w["name"] in e.get("workloads", [w["name"]])
        e2e = [e["name"] for e in m["end_to_end"] if has(e)]
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = [e for e in m["per_layer"] if has(e)]
        assert layer
        # each per-layer metric's end-to-end metric is reported there
        assert all(e["moves"] in e2e for e in layer)


def test_layers_are_named_alike():
    m = _m()
    perf = (REPO / "PERF.md").read_text()
    for e in m["per_layer"]:
        assert e["layer"] in perf, e["layer"]
