"""The int8 talker step kernel K3 (ops/kernels/talker_step): the sum over
its calls in the traced span of the least time of a call (roofline.
k3_call: weights and scales once, and the K/V rows of every row at the
mean position of the window's decode steps, worked out from the
requests' own prefix and output lengths), over the union of its
kernels' device intervals, in %."""

from benchmark import records, roofline

UNIT = "%"


def _least(rec):
    rows = records.kv_rows_per_row(rec)
    if rows is None:
        return None
    B = rec["batch_size"]
    n_bytes, flops = roofline.k3_call(rec["config"]["talker"], B, B * rows)
    return roofline.least_s(n_bytes, flops)


def read(rec):
    return records.roofline_pct(rec, "K3", _least)
