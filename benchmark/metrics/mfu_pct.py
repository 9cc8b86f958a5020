"""The whole step (talker, code predictor, vocoder): records.mfu_pct, the
model's operations for the work that the measured window finished over
the card's peaks (bf16 for the talker and code predictor, FP32 for the
vocoder), over the window's seconds on the host's clock. Serves mfu_pct
and mfu_pct.stream, which BENCHMARK.json splits by the end-to-end metric
each moves."""

from benchmark import records

UNIT = "%"


def read(rec):
    return records.mfu_pct(rec)
