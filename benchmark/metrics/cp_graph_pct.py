"""The decode loop (engine/generate.run_steps): 100 x the loop steps
whose code predictor prelude (the 2-token prefill, lm_head 0 and the
group-1 draw ahead of K2) replayed a CUDA graph, over the loop steps of
the chunks dispatched in the window: the ``dispatch`` spans' ``cp_graph``
over their ``steps``. Nothing on a program whose spans carry no
``cp_graph``, nor on a run on the host, where no graph is taken."""

from benchmark import program_trace

UNIT = "%"


def read(rec):
    if (rec.get("trace") or {}).get("power", "host") == "host":
        return None
    w = program_trace.window(rec)
    if w is None:
        return None
    attr = program_trace.attr
    graphed = steps = 0
    seen = False
    for d in w.named("dispatch"):
        if w.in_window(d.start):
            seen = seen or attr(d, "cp_graph") is not None
            graphed += attr(d, "cp_graph", 0)
            steps += attr(d, "steps")
    return 100.0 * graphed / steps if seen and steps else None
