"""The batcher's admission (serve/batching.ContinuousBatcher._admit): the
85th percentile over the streaming requests due in the window of the
request's t_admit minus its scheduled send time, in ms."""

from benchmark import records

UNIT = "ms"


def read(rec):
    v = records.percentile(records.latencies(rec, "due", "admit"), 85)
    return None if v is None else 1e3 * v
