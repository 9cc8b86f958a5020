"""The program's own spans, read from its recorder
(qwen3_tts_tpu_torch.utils.profiling) after a run, for the per-layer
metrics whose source is ``program_span``.

The ring holds perf_counter ns; the record holds seconds from the
window's start. The window's start on the ring's clock is the offset
that maps the most of the record's ``admit`` times onto the ends of the
ring's ``admit`` spans (the batcher stamps ``t_admit`` as that end, and
the harness writes ``admit = t_admit - t0``), within JOIN_NS. Every
request of the record that was admitted is then joined to its ring
request id (``rid``) by that end, and checked by its ``request`` span,
whose end is its ``t_done``.

``window(rec)`` is None (and so is every metric read through it) when
the program has no recorder (a program older than its spans), when the
ring dropped entries of the batcher's life, or when an admitted request
due in the window has no admission in the ring."""

from __future__ import annotations

import bisect
import collections
import math
from typing import Dict, List, Optional

from benchmark import records

JOIN_NS = 1000


def _ring():
    """(entries, dropped) of the program's recorder, or None."""
    try:
        from qwen3_tts_tpu_torch.utils import profiling
    except ImportError:
        return None
    entries = getattr(profiling, "entries", None)
    dropped = getattr(profiling, "dropped", None)
    if not callable(entries) or not callable(dropped):
        return None
    return entries(), dropped()


def attr(e, key, default=None):
    """An entry's attribute ``key``."""
    return (e.attrs or {}).get(key, default)


def _window_start(rec: dict, admit_ends: List[int]) -> Optional[float]:
    """The window's start in perf_counter ns: the offset under which the
    most record admissions land on a ring admission's end."""
    times = [r["admit"] for r in rec["requests"] if r["admit"] is not None]
    if not times or not admit_ends:
        return None
    votes = collections.Counter()
    for a in times:
        for e in admit_ends:
            votes[round((e - a * 1e9) / JOIN_NS)] += 1
    best, _ = votes.most_common(1)[0]
    cands = [e - a * 1e9 for a in times for e in admit_ends
             if abs(round((e - a * 1e9) / JOIN_NS) - best) <= 1]

    def hits(t0):
        return sum(_nearest(admit_ends, t0 + a * 1e9) is not None
                   for a in times)
    return max(cands, key=hits)


def _nearest(sorted_ns: List[int], t: float) -> Optional[int]:
    """The value of ``sorted_ns`` within JOIN_NS of ``t``, if any."""
    i = bisect.bisect_left(sorted_ns, t - JOIN_NS)
    if i < len(sorted_ns) and abs(sorted_ns[i] - t) <= JOIN_NS:
        return sorted_ns[i]
    return None


class Window:
    """The batcher's spans over one run's record: ``t0``/``t1`` (the
    window in perf_counter ns), ``spans`` (the ring over the batcher's
    life: from the start of its ``setup``), ``setup`` and, for each
    record request that was admitted, its ``admit`` span (``admits``,
    keyed by the request's index in the record)."""

    def __init__(self, rec: dict, spans: list, setup, t0: float,
                 admits: Dict[int, object]):
        self.rec, self.spans, self.setup = rec, spans, setup
        self.t0, self.t1 = t0, t0 + rec["seconds"] * 1e9
        self.admits = admits
        self.by_id = {e.id: e for e in spans}

    def named(self, name: str) -> list:
        return [e for e in self.spans if e.name == name]

    def in_window(self, t: float) -> bool:
        return self.t0 <= t < self.t1

    def ancestor(self, e, name: str):
        """``e``'s nearest enclosing span named ``name``, or None."""
        while e is not None and e.name != name:
            e = self.by_id.get(e.parent)
        return e

    def stream_p85_ms(self, value) -> Optional[float]:
        """The 85th percentile over the streaming requests due in the
        window of ``value(admit span)`` (ns) in ms; a request that failed,
        was not admitted or has no value counts as infinite (as
        records.latencies)."""
        out = []
        for i, r in enumerate(self.rec["requests"]):
            if not (0.0 <= r["due"] < self.rec["seconds"]) or not r["stream"]:
                continue
            a = self.admits.get(i)
            v = None if r["failed"] or a is None else value(a)
            out.append(math.inf if v is None else v / 1e6)
        return records.percentile(out, 85)


def window(rec: dict) -> Optional[Window]:
    ring = _ring()
    if ring is None:
        return None
    entries, dropped = ring
    admit_all = [e for e in entries
                 if e.name == "admit" and attr(e, "outcome") == "ok"]
    t0 = _window_start(rec, sorted(e.end for e in admit_all))
    if t0 is None:
        return None
    setups = [e for e in entries if e.name == "setup" and e.end <= t0]
    if not setups:
        return None
    setup = setups[-1]
    if dropped and entries and entries[0].end >= setup.start:
        return None     # the ring lost entries of this batcher's life
    spans = [e for e in entries if e.start >= setup.start]
    by_end = {e.end: e for e in spans
              if e.name == "admit" and attr(e, "outcome") == "ok"}
    ends = sorted(by_end)
    done_at = {e.end: e for e in spans if e.name == "request"}
    done_ends = sorted(done_at)
    admits = {}
    for i, r in enumerate(rec["requests"]):
        if r["admit"] is None:
            continue
        hit = _nearest(ends, t0 + r["admit"] * 1e9)
        if hit is not None and r["done"] is not None:
            d = _nearest(done_ends, t0 + r["done"] * 1e9)
            if d is None or done_at[d].rid != by_end[hit].rid:
                hit = None
        if hit is None:
            if 0.0 <= r["due"] < rec["seconds"]:
                return None     # an admitted request due in the window
            continue
        admits[i] = by_end[hit]
    return Window(rec, spans, setup, t0, admits)
