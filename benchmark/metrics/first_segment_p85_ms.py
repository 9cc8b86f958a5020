"""The decode loop and the vocoder stream after admission
(engine/generate.run_steps, models/vocoder_stream): the 85th percentile
over the streaming requests due in the window of their first on_chunk
call minus t_admit, in ms."""

from benchmark import records

UNIT = "ms"


def read(rec):
    v = records.percentile(records.latencies(rec, "admit", "first"), 85)
    return None if v is None else 1e3 * v
