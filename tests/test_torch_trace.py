"""The port's recorder (qwen3_tts_tpu_torch.utils.profiling) and the
spans and counters the continuous batcher records, on the CPU at tiny
geometry: nesting and request ids, the queue and admission spans against
the request's own stamps, the codes that chunks commit against the
codes that requests return, the profiler mirror and its clock, the
ring's bound, the stage timer, the build span and the lockstep front
end's first-audio stamp."""

import collections
import json
import time
import types

import numpy as np
import pytest
import torch

from qwen3_tts_tpu_torch import config as pconfig
from qwen3_tts_tpu_torch.io import weights as tweights
from qwen3_tts_tpu_torch.serve import batching as tbatching
from qwen3_tts_tpu_torch.serve import daemon as tdaemon
from qwen3_tts_tpu_torch.serve import lockstep
from qwen3_tts_tpu_torch.utils import profiling

torch.set_num_threads(1)

CFG = pconfig.tiny_tts_config(max_tokens=40)
TEXTS = ["Hello there, friend", "abc", "Hi", "Привет", "xyz"]


@pytest.fixture(scope="module")
def params():
    return tweights.init_random_params(CFG, seed=0, dtype=torch.float32)


def _ids(text, n=32):
    raw = list(text.encode("utf-8"))[:n]
    arr = np.zeros(n, np.int32)
    arr[:len(raw)] = raw
    return arr, len(raw)


def _since(t_ns):
    return [e for e in profiling.entries() if e.start >= t_ns]


def _serve(params, depth, paged=False):
    """Five requests, odd ones streaming, through 3 slots; returns
    (batcher, futures, the ring's entries since the batcher's set-up)."""
    t = time.perf_counter_ns()
    kw = dict(paged=True, page_size=16) if paged else {}
    b = tbatching.ContinuousBatcher(CFG, params, batch_size=3,
                                    decode_chunk=8, dtype=torch.float32,
                                    device="cpu", pipeline_depth=depth,
                                    **kw)
    futs = [b.submit(*_ids(s), seed=i,
                     on_chunk=(lambda part: None) if i % 2 else None)
            for i, s in enumerate(TEXTS)]
    for _ in range(400):
        if all(f.done() for f in futs):
            break
        b.step()
    for f in futs:
        f.result(timeout=1)
    return b, futs, _since(t)


@pytest.fixture(scope="module", params=[1, 2], ids=["depth1", "depth2"])
def served(request, params):
    return _serve(params, request.param)


def test_spans_nest_under_their_parents_and_carry_the_rid(served):
    b, futs, es = served
    by_id = {e.id: e for e in es}

    def parent(e):
        return by_id[e.parent].name if e.parent is not None else None
    kids = collections.defaultdict(set)
    for e in es:
        kids[e.name].add(parent(e))
    assert kids["setup"] == {None}
    for name in ("cast", "quantize", "to_device", "kv_init"):
        assert kids[name] == {"setup"}, name
    for name in ("evict", "admissions", "dispatch", "harvest"):
        assert kids[name] == {"step"}, name
    assert kids["admit"] == {"admissions"}
    assert kids["done_read"] == {"dispatch"}
    assert kids["status_read"] <= {"step", "harvest"}
    for name in ("stream", "codes_read", "segment_read", "vocode",
                 "first_audio"):
        assert kids[name] == {"harvest"}, name
    assert kids["vocode_read"] == {"vocode"}
    assert kids["queue"] == kids["request"] == {None}
    rids = sorted(f.request.order for f in futs)
    for name in ("queue", "admit", "request"):
        assert sorted(e.rid for e in es if e.name == name) == rids, name
    # a streaming request's first segment: its mark, its stamp and the
    # chunk that emitted it
    cids = {e.attrs["cid"] for e in es if e.name == "dispatch"}
    for f in futs:
        r = f.request
        marks = [e for e in es if e.name == "first_audio"
                 and e.rid == r.order]
        if r.on_chunk is None:
            assert not marks and r.t_first_audio is None
        else:
            assert len(marks) == 1 and marks[0].attrs["cid"] in cids
            assert r.t_first_audio == marks[0].start / 1e9
            assert r.t_admit < r.t_first_audio <= r.t_done
    assert all(e.attrs["rows"] == 3 for e in es if e.name == "dispatch")


def test_queue_plus_admit_is_the_admission_wait(served):
    _, futs, es = served
    for f in futs:
        r = f.request
        (q,) = [e for e in es if e.name == "queue" and e.rid == r.order]
        (a,) = [e for e in es if e.name == "admit" and e.rid == r.order]
        (d,) = [e for e in es if e.name == "request" and e.rid == r.order]
        assert q.end == a.start and a.attrs["outcome"] == "ok"
        assert (q.end - q.start) + (a.end - a.start) == (
            round(r.t_admit * 1e9) - round(r.t_submit * 1e9))
        assert r.t_admit == a.end / 1e9 and r.t_done == d.end / 1e9
        assert d.attrs["outcome"] == "ok"


@pytest.mark.parametrize("depth,paged", [(1, False), (2, False), (2, True)],
                         ids=["depth1", "depth2", "depth2-paged"])
def test_codes_committed_equal_the_requests_codes(params, depth, paged):
    """Summed over the chunks' harvests, the committed codes are the
    finished requests' codes; the batcher's counters, which count from
    its set-up, agree with the spans."""
    b, futs, es = _serve(params, depth, paged)
    n_codes = sum(len(f.result(timeout=0)[0]) for f in futs)
    harvests = [e for e in es if e.name == "harvest"]
    assert sum(e.attrs["codes"] for e in harvests) == n_codes
    dispatches = [e for e in es if e.name == "dispatch"]
    assert len({e.attrs["cid"] for e in dispatches}) == len(dispatches)
    assert {e.attrs["cid"] for e in harvests} <= {
        e.attrs["cid"] for e in dispatches}
    grew = b.occupancy()["counters"]
    assert grew["codes_committed"] == n_codes
    assert grew["chunks"] == len(dispatches)
    assert grew["loop_steps"] == sum(e.attrs["steps"] for e in dispatches)
    assert grew["row_steps"] == 3 * grew["loop_steps"]
    assert grew["done_reads"] == len([e for e in es
                                      if e.name == "done_read"])
    assert grew["status_reads"] == len([e for e in es
                                        if e.name == "status_read"])
    assert grew["admissions"] == len(futs)
    assert grew["segments"] == len([e for e in es
                                    if e.name == "segment_read"])
    # useful row-steps are fewer than the row-steps run
    assert 0 < grew["codes_committed"] <= grew["row_steps"]


def test_a_batchers_counters_start_at_its_set_up(params):
    """occupancy()'s counters and prefix cache counts leave out what
    batchers built before it counted."""
    _serve(params, 1)
    b, futs, _ = _serve(params, 2)
    c = b.occupancy()["counters"]
    assert c["admissions"] == len(futs) == b.occupancy()[
        "prefix_cache"]["misses"]
    assert c["launches_K2"] >= 0 and c["spans_dropped"] == 0


def test_failed_requests_record_their_outcome(params):
    """Requests withdrawn in their slot and in the queue (as the daemon
    withdraws one whose client left), and one failed by stop(), each
    record the span ``request`` with its outcome, and keep t_done None."""
    b = tbatching.ContinuousBatcher(CFG, params, batch_size=1,
                                    decode_chunk=4, dtype=torch.float32,
                                    device="cpu")
    t = time.perf_counter_ns()
    held = b.submit(*_ids("Hello"), seed=1)
    b.step()
    queued = b.submit(*_ids("abc"), seed=2)
    left = b.submit(*_ids("xyz"), seed=3)
    held.request.cancelled = queued.request.cancelled = True
    b.step()
    b.stop(drain=False)
    outcome = {e.rid: e.attrs["outcome"] for e in _since(t)
               if e.name == "request"}
    assert outcome == {held.request.order: "cancelled",
                       queued.request.order: "cancelled",
                       left.request.order: "error"}
    for f in (held, queued, left):
        assert f.exception(timeout=0) and f.request.t_done is None


def test_an_idle_batcher_records_nothing(params):
    b = tbatching.ContinuousBatcher(CFG, params, batch_size=2,
                                    decode_chunk=4, dtype=torch.float32,
                                    device="cpu")
    assert b.step() is False            # the first reads the status
    t = time.perf_counter_ns()
    assert not any(b.step() for _ in range(50))
    assert _since(t) == []


def test_the_mirror_places_spans_on_the_profilers_clock(tmp_path):
    """Inside device_trace every span is a range of the profiler, and
    to_profiler_ns puts the span's ends within 1 ms of the range's (the
    outer span's start is left out: a process's first range opens about
    1 ms before the span's start is stamped)."""
    with profiling.device_trace(str(tmp_path), "cpu") as prof:
        with profiling.span("mirrored_outer") as outer:
            with profiling.span("mirrored_inner") as inner:
                time.sleep(0.002)
    assert [p.name for p in tmp_path.iterdir()] != []
    ranges = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.is_user_annotation()}
    assert {"mirrored_outer", "mirrored_inner"} <= set(ranges)
    for sp, at in ((inner, "start"), (inner, "end"), (outer, "end")):
        r = ranges[sp.name]
        got = r.start_ns() + (r.duration_ns() if at == "end" else 0)
        assert abs(profiling.to_profiler_ns(getattr(sp, at)) - got) < 1e6
    assert not profiling.RECORDER.mirror


def test_a_foreign_profiler_sees_no_range_from_the_program(params):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("not_mirrored"):
            pass
        _serve(params, 1)
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation()]
    assert names == []


def test_the_ring_drops_its_oldest_entries_and_counts_them(monkeypatch):
    rec = profiling.Recorder(size=4)
    monkeypatch.setattr(profiling, "RECORDER", rec)
    for i in range(6):
        with profiling.span(f"s{i}"):
            pass
    profiling.mark("m", rid=7, cid=1)
    assert [e.name for e in profiling.entries()] == ["s3", "s4", "s5", "m"]
    assert profiling.dropped() == 3
    assert profiling.snapshot()["dropped"] == 3
    profiling.count("x")
    profiling.count("x", 4)
    assert profiling.snapshot()["counters"] == {"x": 5}


def test_stage_fills_timings_and_records_a_span():
    timings = {}
    t = time.perf_counter_ns()
    for _ in range(2):
        with profiling.stage(timings, "staged"):
            time.sleep(0.001)
    with pytest.raises(KeyError):
        with profiling.stage(timings, "raised"):
            raise KeyError("x")
    spans = [e for e in _since(t) if e.name in ("staged", "raised")]
    assert [e.name for e in spans] == ["staged", "staged", "raised"]
    assert timings["staged"] == pytest.approx(
        sum(e.seconds for e in spans[:2]))
    assert timings["staged"] >= 0.002 and "raised" in timings


def test_the_build_span_says_whether_nvcc_ran(monkeypatch, tmp_path):
    from qwen3_tts_tpu_torch.ops.kernels import _build
    lib = tmp_path / "lib.so"
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "library_path", lambda: lib)
    monkeypatch.setattr(_build, "_compile", lambda p: p.write_bytes(b""))
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: types.
                        SimpleNamespace(q3_error_string=types.
                                        SimpleNamespace()))
    t = time.perf_counter_ns()
    _build.load()
    monkeypatch.setattr(_build, "_lib", None)
    _build.load()
    builds = [e for e in _since(t) if e.name == "build"]
    assert [e.attrs["nvcc"] for e in builds] == [True, False]


def test_the_lockstep_front_copies_the_first_audio_stamp(params):
    """One rank without a group: the front end's request carries the
    local request's t_first_audio beside t_first."""
    b = tbatching.ContinuousBatcher(CFG, params, batch_size=2,
                                    decode_chunk=8, dtype=torch.float32,
                                    device="cpu")
    front = lockstep.LockstepFront(lockstep.LockstepRank(b, None))
    front.start()
    try:
        parts = []
        fut = front.submit(*_ids("Hello"), seed=1, on_chunk=parts.append)
        fut.result(timeout=120)
    finally:
        front.stop(timeout=60)
    r = fut.request
    assert parts and r.t_first is not None
    assert r.t_admit < r.t_first_audio <= r.t_done


def test_the_daemons_profile_shows_the_batchers_spans(tmp_path,
                                                     monkeypatch):
    """``daemon --batch 2 --profile DIR`` (its socket loop replaced by one
    request of 3 tokens): the trace written at the end holds the
    batcher's set-up and its steps' spans as ranges, those of the
    scheduler thread included."""
    def serve_one(args, engine, batcher):
        batcher.start()
        try:
            batcher.submit(*_ids("profiled"), seed=3,
                           max_tokens=3).result(timeout=120)
        finally:
            batcher.stop()
        return 0
    monkeypatch.setattr(tdaemon, "serve_main", serve_one)
    out = tmp_path / "trace"
    assert tdaemon.main(["--tiny", "--device", "cpu", "--dtype", "float32",
                         "--batch", "2", "--decode_chunk", "2",
                         "--profile", str(out)]) == 0
    (trace,) = out.iterdir()
    ranges = collections.defaultdict(set)
    for e in json.loads(trace.read_text())["traceEvents"]:
        if e.get("cat") == "user_annotation":
            ranges[e["name"]].add(e["tid"])
    for name in ("setup", "cast", "quantize", "to_device", "kv_init",
                 "step", "evict", "admissions", "admit", "dispatch",
                 "done_read", "harvest", "status_read", "codes_read",
                 "vocode", "vocode_read"):
        assert name in ranges, name
    assert ranges["step"].isdisjoint(ranges["setup"])  # another thread
    assert not profiling.RECORDER.mirror
