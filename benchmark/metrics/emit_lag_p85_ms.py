"""The harvest and the vocoder stream (ContinuousBatcher._harvest,
models/vocoder_stream): the 85th percentile over the streaming requests
due in the window of the program's ``first_audio`` mark (the first
segment handed to on_chunk) minus the end of the ``dispatch`` span of
the chunk whose harvest emitted it, in ms. A request that failed, was
not admitted or sent no segment counts as infinite."""

from benchmark import program_trace

UNIT = "ms"


def read(rec):
    w = program_trace.window(rec)
    if w is None:
        return None
    firsts = {m.rid: m for m in w.named("first_audio")}
    dispatched = {program_trace.attr(d, "cid"): d.end
                  for d in w.named("dispatch")}

    def lag(admit):
        m = firsts.get(admit.rid)
        if m is None:
            return None
        end = dispatched.get(program_trace.attr(m, "cid"))
        return None if end is None else m.start - end
    return w.stream_p85_ms(lag)
