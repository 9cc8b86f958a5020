"""Helpers the metric readers share. A run's record holds, for every
request it sent, its times in seconds from the window's start (``due``:
scheduled send; ``sent``; ``admit``, ``done``: the batcher's own
``t_admit``/``t_done``; ``first``: the first on_chunk call), its sizes
(``n_text``, ``n_codes``, ``audio_s``) and ``failed``; the window's
``seconds``; and in a traced run ``trace`` (trace.reduce)."""

from __future__ import annotations

import math
from typing import List, Optional


def percentile(values: List[float], p: float) -> Optional[float]:
    """Nearest rank: the smallest sample with at least p% of the samples
    at or below it. Failures enter as infinity and sort last."""
    if not values:
        return None
    v = sorted(values)
    return v[max(0, math.ceil(p / 100.0 * len(v)) - 1)]


def due_in_window(rec: dict) -> List[dict]:
    return [r for r in rec["requests"] if 0.0 <= r["due"] < rec["seconds"]]


def latencies(rec: dict, start: str, end: str,
              stream_only: bool = True) -> List[float]:
    """end - start of every request due in the window (streaming ones
    only by default); a failed request, or one without ``end``, is
    infinite."""
    out = []
    for r in due_in_window(rec):
        if stream_only and not r["stream"]:
            continue
        if r["failed"] or r[end] is None or r[start] is None:
            out.append(math.inf)
        else:
            out.append(r[end] - r[start])
    return out


def finished_in_window(rec: dict) -> List[dict]:
    return [r for r in rec["requests"] if not r["failed"]
            and r["done"] is not None and 0.0 <= r["done"] <= rec["seconds"]]


def kv_rows_per_row(rec: dict) -> Optional[float]:
    """The mean number of K/V positions a decode step's row reads, over
    every step of every request finished in the window, worked out from
    the requests' own prefix (n_text + 9) and output lengths: step i of a
    request reads positions 0..n_text + 9 + i."""
    steps, rows = 0, 0.0
    for r in finished_in_window(rec):
        P, n = r["n_text"] + 9, r["n_codes"]
        steps += n
        rows += n * (P + 1) + n * (n - 1) / 2
    return rows / steps if steps else None


def roofline_pct(rec: dict, label: str, least_s_a_call) -> Optional[float]:
    """100 x (the sum over a kernel's calls in the traced span of their
    least time) / (its device time there), or None without a call."""
    t = rec.get("trace")
    if not t:
        return None
    calls = t["label_calls"].get(label, 0)
    dev_s = t["label_s"].get(label, 0.0)
    if not calls or dev_s <= 0:
        return None
    least = least_s_a_call(rec)
    if least is None:
        return None
    return 100.0 * calls * least / dev_s


def mfu_pct(rec: dict) -> Optional[float]:
    """The whole step's share of the card's peak: the model's operations
    for every request finished in the window (its prefill, decode steps,
    code predictor and vocoding, from the configuration's shapes), the
    talker's and code predictor's over the bf16 dense peak (their
    activations are bf16), the FP32 vocoder's over the FP32 peak, summed,
    over the window's seconds on the host's clock, in %."""
    from benchmark import roofline
    cfg = rec["config"]
    budget = int(cfg["max_tokens"])
    done = finished_in_window(rec)
    if not done:
        return None
    tc = voc = 0.0
    for r in done:
        n = r["n_codes"]
        steps = n + 1 if n < budget else n
        tc += roofline.talker_cp_flops(cfg, r["n_text"], n, steps)
        voc += roofline.vocoder_flops(cfg["vocoder"], n)
    busy = tc / roofline.BF16_FLOPS + voc / roofline.FP32_FLOPS
    return 100.0 * busy / rec["seconds"]
