"""The batcher's slots: the slot time requests held inside the window
(each request's t_admit to t_done, clipped to the window) over batch
size x window, in %."""

UNIT = "%"


def read(rec):
    T = rec["seconds"]
    held = 0.0
    for r in rec["requests"]:
        if r["admit"] is None:
            continue
        end = r["done"] if r["done"] is not None else T
        held += max(0.0, min(end, T) - max(r["admit"], 0.0))
    return 100.0 * held / (rec["batch_size"] * T) if held else None
