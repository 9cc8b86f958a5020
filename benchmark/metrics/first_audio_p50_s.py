"""The 50th percentile (nearest rank) over every streaming request due in
the window of its first on_chunk call minus its scheduled send time; a
request that failed, or sent no audio by the drain limit, counts as
infinitely late."""

from benchmark import records

UNIT = "s"


def read(rec):
    return records.percentile(records.latencies(rec, "due", "first"), 50)
