"""A request's own admission (ContinuousBatcher._admit: the prefix LRU,
the prefix, the prefill and the splice into its slot): the 85th
percentile over the streaming requests due in the window of the
program's ``admit`` span, in ms. A request that failed or was not
admitted counts as infinite."""

from benchmark import program_trace

UNIT = "ms"


def read(rec):
    w = program_trace.window(rec)
    if w is None:
        return None
    return w.stream_p85_ms(lambda admit: admit.end - admit.start)
