"""The metric arithmetic: nearest-rank percentiles with failures last, a
rate over the whole window, device idle as a union of intervals, and the
readers found by name."""

import math

from benchmark import records, trace
from benchmark.tests.tiny import REPO


def _reader(name):
    from benchmark import harness
    return harness.metric_module(REPO / "benchmark", name)


def _req(**kw):
    base = dict(due=0.0, sent=0.0, admit=None, first=None, done=None,
                n_text=10, n_codes=0, audio_s=0.0, stream=True,
                failed=False)
    base.update(kw)
    return base


def test_percentile_has_ten_samples_beyond():
    vals = list(range(1, 72))           # 71 samples, as the stream cell
    p85 = records.percentile(vals, 85)
    assert sum(v > p85 for v in vals) == 10
    assert records.percentile([3.0, 1.0, 2.0], 50) == 2.0
    assert records.percentile([], 50) is None
    assert records.percentile([1.0, math.inf], 90) == math.inf


def test_first_audio_counts_failures_as_late():
    reqs = [_req(due=i * 0.1, first=i * 0.1 + 1.0) for i in range(19)]
    reqs.append(_req(due=1.95, failed=True))
    rec = {"requests": reqs, "seconds": 2.0}
    assert _reader("first_audio_p50_s").read(rec) == 1.0
    assert math.isinf(_reader("first_audio_p85_s").read(
        {"requests": reqs[-3:], "seconds": 2.0}))


def test_rate_is_all_work_over_all_the_window():
    reqs = [_req(stream=False, done=1.0, audio_s=4.0),
            _req(stream=False, done=9.5, audio_s=2.0),
            _req(stream=False, done=10.5, audio_s=8.0),      # after
            _req(stream=False, done=3.0, audio_s=8.0, failed=True)]
    rec = {"requests": reqs, "seconds": 10.0}
    assert _reader("audio_s_per_s").read(rec) == 0.6


def test_slot_busy_clips_to_the_window():
    reqs = [_req(admit=-1.0, done=2.0), _req(admit=3.0, done=12.0)]
    rec = {"requests": reqs, "seconds": 10.0, "batch_size": 2}
    assert abs(_reader("slot_busy_pct").read(rec) - 45.0) < 1e-9


def test_idle_is_a_union_of_intervals():
    spans = [(0, 10), (5, 15), (20, 30), (29, 31)]
    assert trace._union(spans) == 26
    assert trace._merged(spans) == [(0, 15), (20, 31)]
    rec = {"trace": {"span_s": 2.0, "busy_s": 0.5}}
    assert _reader("device_idle_pct.offline").read(rec) == 75.0
    assert _reader("device_idle_pct.stream").read({"trace": None}) is None


def test_innermost_range():
    r = trace._Ranges([(0, 100, "run_steps"), (10, 20, "K2"),
                       (30, 40, "K3"), (32, 35, "K1")])
    assert r.innermost(15) == "K2"
    assert r.innermost(25) == "run_steps"
    assert r.innermost(33) == "K1"
    assert r.innermost(38) == "K3"
    assert r.innermost(150) is None


def test_kv_rows_from_request_lengths():
    reqs = [_req(stream=False, done=1.0, n_text=1, n_codes=3)]
    rec = {"requests": reqs, "seconds": 2.0}
    # prefix 10 rows: steps read 11, 12, 13 positions
    assert records.kv_rows_per_row(rec) == 12.0


def test_roofline_share_reads_nothing_without_calls():
    rec = {"trace": {"label_calls": {}, "label_s": {}}}
    assert records.roofline_pct(rec, "K2", lambda r: 1.0) is None
    rec = {"trace": {"label_calls": {"K2": 4}, "label_s": {"K2": 8.0}}}
    assert records.roofline_pct(rec, "K2", lambda r: 1.0) == 50.0
