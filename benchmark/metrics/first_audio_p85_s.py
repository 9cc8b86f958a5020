"""The client, as listeners hear the stream: the 85th percentile (nearest
rank) over every streaming request due in the window of its first
on_chunk call minus its scheduled send time; a request that failed, or
sent no audio by the drain limit, counts as infinitely late. Read in the
traced run, without a bound: its runs spread too far for any bound up to
0.25, the widest a bound may be (PERF.md)."""

from benchmark import records

UNIT = "s"


def read(rec):
    return records.percentile(records.latencies(rec, "due", "first"), 85)
