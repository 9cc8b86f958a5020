"""The batcher's admission queue (ContinuousBatcher._next_request): the
85th percentile over the streaming requests due in the window of the
program's ``queue`` span (submit to the start of the admission that
placed the request; retries of the paged backlog count as queue), in ms.
A request that failed or was not admitted counts as infinite."""

from benchmark import program_trace

UNIT = "ms"


def read(rec):
    w = program_trace.window(rec)
    if w is None:
        return None
    # the queue span ends where the admission that placed it starts
    queue = {e.end: e for e in w.named("queue")}

    def wait(admit):
        q = queue.get(admit.start)
        return None if q is None else q.end - q.start
    return w.stream_p85_ms(wait)
