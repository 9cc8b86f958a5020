"""A closed loop: ``clients`` clients, each sending its next request when
its last one has returned, until the window closes. The lengths of each
client's requests run through shuffled copies of the whole stratified
length set, so any stretch of a run holds nearly the same mix."""

from __future__ import annotations

import threading
import time
from concurrent.futures import CancelledError

from benchmark import gen


def plan(params: dict, seed: int, seconds: float) -> list:
    """Every request a run may send, as dicts: ``client``, ``n_text``,
    ``ids``, ``seed``, ``stream`` and ``due`` (None: sent when the
    client's previous request returns)."""
    spec = params["n_text"]
    base = gen.quantile_lengths(spec, int(spec["max"]) - int(spec["min"]) + 1)
    per_client = int(4 * seconds) + 16
    reqs = []
    for c in range(int(params["clients"])):
        g = gen.rng(seed, 1, c)
        lengths = []
        while len(lengths) < per_client:
            lengths += [base[i] for i in g.permutation(len(base))]
        for k in range(per_client):
            n = lengths[k]
            reqs.append({"client": c, "n_text": n, "ids": gen.text_ids(g, n),
                         "seed": gen.request_seed(seed, c * 100000 + k),
                         "stream": bool(params.get("stream", False)),
                         "due": None})
    return reqs


def drive(reqs: list, submit, t0: float, t_end: float,
          stop: threading.Event) -> list:
    """Start one thread a client; each submits its requests in turn from
    ``t0`` on (``submit(req, due)`` returns a Future) and waits for each,
    until ``t_end`` or ``stop``. Returns the threads."""
    by_client = {}
    for r in reqs:
        by_client.setdefault(r["client"], []).append(r)

    def client(mine):
        time.sleep(max(0.0, t0 - time.perf_counter()))
        for r in mine:
            now = time.perf_counter()
            if now >= t_end or stop.is_set():
                return
            try:
                submit(r, now).exception()
            except CancelledError:     # the run is being torn down
                return

    threads = [threading.Thread(target=client, args=(m,), daemon=True)
               for m in by_client.values()]
    for t in threads:
        t.start()
    return threads
