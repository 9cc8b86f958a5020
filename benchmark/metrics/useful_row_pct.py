"""The decode loop's rows (engine/generate.run_steps): 100 x the codes
that the chunks dispatched in the window committed (each held slot's
rise in n_codes, from the program's ``harvest`` span of the chunk) over
their row-steps (rows x loop steps run, from its ``dispatch`` span). A
chunk dropped unharvested, which happens only when every row it ran was
already finished, commits nothing."""

from benchmark import program_trace

UNIT = "%"


def read(rec):
    w = program_trace.window(rec)
    if w is None:
        return None
    attr = program_trace.attr
    codes = {attr(h, "cid"): attr(h, "codes", 0) for h in w.named("harvest")}
    committed = row_steps = 0
    for d in w.named("dispatch"):
        if w.in_window(d.start):
            committed += codes.get(attr(d, "cid"), 0)
            row_steps += attr(d, "rows") * attr(d, "steps")
    return 100.0 * committed / row_steps if row_steps else None
