"""Draws shared by the traffic kinds: stratified lengths and gaps (every
seed gets the same multiset, in another order, so a seed changes which
request comes when and never how much work a run holds), token ids and
per-request seeds."""

from __future__ import annotations

import math
from statistics import NormalDist
from typing import List

import numpy as np

# text ids are drawn below the first special id of the Qwen3 vocabulary
# (<|endoftext|> = 151643)
TEXT_ID_LIMIT = 151643


def rng(seed: int, *tags: int) -> np.random.Generator:
    """A generator for one purpose (``tags``) of one run seed: any whole
    number, also past 64 bits or negative."""
    s = int(seed)
    words = [s & 0xFFFFFFFF, (s >> 32) & 0xFFFFFFFF, (s >> 64) & 0xFFFFFFFF,
             int(s < 0)]
    return np.random.default_rng(words + [int(t) for t in tags])


def quantile_lengths(spec: dict, n: int) -> List[int]:
    """n lengths at the quantiles (i + 0.5) / n of ``spec``'s distribution,
    in rising order: ``uniform`` integers in [min, max], or ``lognormal``
    with ``median`` and ``sigma``, rounded and clipped to [min, max]."""
    lo, hi = int(spec["min"]), int(spec["max"])
    qs = [(i + 0.5) / n for i in range(n)]
    if spec["dist"] == "uniform":
        vals = [lo + min(int(q * (hi - lo + 1)), hi - lo) for q in qs]
    elif spec["dist"] == "lognormal":
        mu, sd = math.log(float(spec["median"])), float(spec["sigma"])
        nd = NormalDist()
        vals = [round(math.exp(mu + sd * nd.inv_cdf(q))) for q in qs]
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return [min(max(v, lo), hi) for v in vals]


def exponential_gaps(n: int, span: float) -> List[float]:
    """n gaps at the quantiles of an exponential distribution, scaled so
    that they add up to ``span`` (a Poisson process's arrivals with the
    count fixed), in rising order."""
    gaps = [-math.log(1.0 - (i + 0.5) / n) for i in range(n)]
    total = sum(gaps)
    return [g * span / total for g in gaps]


def text_ids(g: np.random.Generator, n_text: int) -> np.ndarray:
    return g.integers(0, TEXT_ID_LIMIT, size=n_text, dtype=np.int64).astype(
        np.int32)


def request_seed(seed: int, index: int) -> int:
    """A request's sampling seed: 63 bits hashed from the run seed."""
    return int(rng(seed, 7, index).integers(0, 2 ** 63 - 1, dtype=np.int64))
