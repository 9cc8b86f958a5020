"""The reader of ``cp_graph_pct`` over a synthetic ring: the window's
``dispatch`` spans' ``cp_graph`` over their ``steps``, nothing from a
program whose spans carry no ``cp_graph`` (the parent of the graph) and
nothing from a run on the host."""

import types

import pytest

from benchmark import program_trace
from benchmark.tests.tiny import REPO

S = 10 ** 9


def _reader():
    from benchmark import harness
    return harness.metric_module(REPO / "benchmark", "cp_graph_pct")


def _span(i, name, start, **attrs):
    return types.SimpleNamespace(id=i, name=name, start=start,
                                 end=start + 1000, parent=None, rid=None,
                                 attrs=attrs or None)


def _ring(monkeypatch, spans, t0=5 * S, seconds=10.0):
    rec = {"seconds": seconds, "requests": [],
           "trace": {"power": "NVIDIA H100 80GB HBM3, 700.00 W"}}
    setup = _span(0, "setup", 0)
    w = program_trace.Window(rec, [setup] + spans, setup, t0, {})
    monkeypatch.setattr(program_trace, "window", lambda r: w)
    return rec


def test_reads_the_windows_graphed_steps_over_its_steps(monkeypatch):
    rec = _ring(monkeypatch, [
        _span(1, "dispatch", 4 * S, steps=32, cp_graph=0),     # before
        _span(2, "dispatch", 6 * S, steps=32, cp_graph=32),
        _span(3, "dispatch", 7 * S, steps=16, cp_graph=8),
        _span(4, "harvest", 7 * S, codes=40),
        _span(5, "dispatch", 15 * S, steps=32, cp_graph=0)])   # after
    assert _reader().read(rec) == pytest.approx(100.0 * 40 / 48)


def test_reads_nothing_without_cp_graph_or_steps(monkeypatch):
    rec = _ring(monkeypatch, [_span(1, "dispatch", 6 * S, steps=32,
                                    rows=8, done_reads=4)])
    assert _reader().read(rec) is None
    rec = _ring(monkeypatch, [_span(1, "dispatch", 6 * S, steps=0,
                                    cp_graph=0)])
    assert _reader().read(rec) is None
    rec = _ring(monkeypatch, [])
    assert _reader().read(rec) is None


@pytest.mark.parametrize("trace", [None, {"power": "host"}])
def test_reads_nothing_on_the_host(monkeypatch, trace):
    rec = _ring(monkeypatch, [_span(1, "dispatch", 6 * S, steps=32,
                                    cp_graph=0)])
    rec["trace"] = trace
    assert _reader().read(rec) is None
    rec["trace"] = {"power": "unknown"}
    assert _reader().read(rec) == 0.0
