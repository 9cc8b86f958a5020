"""The code predictor's kernel K2 (ops/kernels/cp_decode.cp_decode_steps):
the sum over its calls in the traced span of the least time of a call
at the batch's rows (roofline.k2_call: every input read once, every
output written once, against 3.35 TB/s, or its operations against the
bf16 peak), over the union of its kernels' device intervals, in %."""

from benchmark import records, roofline

UNIT = "%"


def _least(rec):
    n_bytes, flops = roofline.k2_call(rec["config"]["code_predictor"],
                                      rec["batch_size"])
    return roofline.least_s(n_bytes, flops)


def read(rec):
    return records.roofline_pct(rec, "K2", _least)
