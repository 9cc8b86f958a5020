"""The per-layer metrics read from the program's own spans
(benchmark/program_trace.py) on tiny traced runs on the CPU: every
request due in the window is joined to its spans, every new metric
reads a number, the metrics read before them read the same whatever
the ring holds, and a program without a recorder (the parent of the
spans) reads nothing and raises nothing."""

import math

import pytest

from benchmark import harness, program_trace
from benchmark.tests import tiny

NEW = {"int8-b8-offline": ("useful_row_pct", "host_wait_pct.offline",
                           "batcher_init_s"),
       "bf16-paged-b8-stream": ("queue_wait_p85_ms", "admit_host_p85_ms",
                                "emit_lag_p85_ms", "host_wait_pct.stream",
                                "batcher_init_s")}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.fixture(scope="module", params=sorted(NEW))
def traced(request, root):
    return request.param, tiny.run(root, request.param, seed=21,
                                   trace=True)


def _read(root, name, rec):
    return harness.metric_module(root / "benchmark", name).read(rec)


def test_every_request_joins_and_every_new_metric_reads(traced):
    cell, r = traced
    rec = r["_record"]
    w = program_trace.window(rec)
    assert w is not None
    admitted = [i for i, q in enumerate(rec["requests"])
                if q["admit"] is not None]
    assert sorted(w.admits) == admitted
    for i, a in w.admits.items():
        assert abs(w.t0 + rec["requests"][i]["admit"] * 1e9 - a.end) < 1e3
    for name in NEW[cell]:
        v = r["metrics"][name]["value"]
        assert math.isfinite(v) and v >= 0, name
    if cell.startswith("int8"):
        assert 0 < r["metrics"]["useful_row_pct"]["value"] <= 100
    else:
        # a request's admission wait is its queue wait and its admission
        m = {k: v["value"] for k, v in r["metrics"].items()}
        assert m["queue_wait_p85_ms"] <= m["admit_wait_p85_ms"] + 1e-6


def test_the_older_metrics_read_the_same_and_the_new_none_without_spans(
        traced, root, monkeypatch):
    cell, r = traced
    rec = r["_record"]
    older = {k: v["value"] for k, v in r["metrics"].items()
             if k not in NEW[cell]}
    from qwen3_tts_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, "RECORDER", profiling.Recorder())
    assert program_trace.window(rec) is None
    for name in older:
        assert _read(root, name, rec) == older[name], name
    # a program whose profiling module has no recorder
    monkeypatch.delattr(profiling, "entries")
    for name in NEW[cell]:
        assert _read(root, name, rec) is None, name


def test_a_ring_that_dropped_the_batchers_entries_reads_nothing(
        traced, monkeypatch):
    """Entries dropped before the batcher's set-up leave the window
    whole; dropped after it, the window reads nothing."""
    _cell, r = traced
    rec = r["_record"]
    from qwen3_tts_tpu_torch.utils import profiling
    setup = program_trace.window(rec).setup
    life = [e for e in profiling.entries() if e.start >= setup.start]
    older = profiling.Span("older")
    older.start = older.end = setup.start - 1
    for kept in ([older] + life, life):
        ring = profiling.Recorder()
        ring.ring.extend(kept)
        ring.dropped = 1
        monkeypatch.setattr(profiling, "RECORDER", ring)
        w = program_trace.window(rec)
        assert (w is None) == (kept is life)
