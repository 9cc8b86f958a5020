"""Paged decode attention K4 (ops/kernels/paged_attention), one call a
layer: the sum over its calls in the traced span of the least time of a
call (roofline.k4_call: the K/V rows of every row at the mean position
of the window's decode steps, from the requests' own lengths, the page
table, q and the output), over the union of its kernels' device
intervals, in %."""

from benchmark import records, roofline

UNIT = "%"


def _least(rec):
    rows = records.kv_rows_per_row(rec)
    if rows is None:
        return None
    B = rec["batch_size"]
    n_bytes, flops = roofline.k4_call(rec["config"]["talker"], B, B * rows,
                                      rec["max_pages"])
    return roofline.least_s(n_bytes, flops, roofline.FP32_FLOPS)


def read(rec):
    return records.roofline_pct(rec, "K4", _least)
