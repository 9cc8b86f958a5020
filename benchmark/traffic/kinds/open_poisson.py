"""An open loop: requests due on the schedule of a Poisson process at
``rate_per_s``, sent when due whether or not earlier ones have returned.
The count in a window is fixed (rate x seconds) and the gaps are the
stratified quantiles of the exponential distribution, shuffled by the
seed, so every seed offers the same load in another order."""

from __future__ import annotations

import threading
import time

from benchmark import gen


def plan(params: dict, seed: int, seconds: float) -> list:
    """The requests due in a window of ``seconds``: dicts with ``due``
    (seconds after the window opens), ``client`` (0), ``n_text``,
    ``ids``, ``seed`` and ``stream``."""
    n = max(1, round(float(params["rate_per_s"]) * seconds))
    g = gen.rng(seed, 2)
    gaps = gen.exponential_gaps(n, seconds * (1.0 - 0.5 / n))
    gaps = [gaps[i] for i in g.permutation(n)]
    lengths = gen.quantile_lengths(params["n_text"], n)
    lengths = [lengths[i] for i in g.permutation(n)]
    reqs, due = [], 0.0
    for k in range(n):
        due += gaps[k]
        reqs.append({"client": 0, "n_text": lengths[k],
                     "ids": gen.text_ids(g, lengths[k]),
                     "seed": gen.request_seed(seed, k),
                     "stream": bool(params.get("stream", False)),
                     "due": due})
    return reqs


def drive(reqs: list, submit, t0: float, t_end: float,
          stop: threading.Event) -> list:
    """One sender thread: each request is submitted at ``t0 + due``
    (``submit(req, scheduled time)``), late if the sender falls behind;
    latencies are taken from the scheduled time. Returns the thread."""

    def sender():
        for r in reqs:
            due = t0 + r["due"]
            time.sleep(max(0.0, due - time.perf_counter()))
            if stop.is_set():
                return
            submit(r, due)

    t = threading.Thread(target=sender, daemon=True)
    t.start()
    return [t]
