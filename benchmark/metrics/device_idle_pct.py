"""The device: 100 x (1 - the union of its kernel and copy intervals over
the traced span's seconds). Serves device_idle_pct.offline and
device_idle_pct.stream, which BENCHMARK.json splits by the end-to-end
metric each moves."""

UNIT = "%"


def read(rec):
    t = rec.get("trace")
    if not t or t["span_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["span_s"])
