"""The scheduler thread (ContinuousBatcher.step): 100 x its time blocked
on device reads (the program's ``status_read``, ``done_read``,
``codes_read``, ``segment_read`` and ``vocode_read`` spans, the last the
whole-request vocoder's fetch) over its time in ``step``, over the steps
begun in the window. Serves host_wait_pct.offline and
host_wait_pct.stream, which BENCHMARK.json splits by the end-to-end
metric each moves."""

from benchmark import program_trace

UNIT = "%"
WAITS = ("status_read", "done_read", "codes_read", "segment_read",
         "vocode_read")


def read(rec):
    w = program_trace.window(rec)
    if w is None:
        return None
    steps = {s.id for s in w.named("step") if w.in_window(s.start)}
    total = sum(s.end - s.start for s in w.named("step") if s.id in steps)
    waited = 0
    for e in w.spans:
        if e.name in WAITS:
            s = w.ancestor(e, "step")
            if s is not None and s.id in steps:
                waited += e.end - e.start
    return 100.0 * waited / total if total else None
