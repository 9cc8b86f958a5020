"""The traffic kinds: the same seed gives the same schedule, another seed
the same work in another order, lengths stay in their ranges."""

import json
from collections import Counter

from benchmark import gen
from benchmark.tests.tiny import REPO


def _kind(name):
    from benchmark import harness
    return harness.kind_module(REPO / "benchmark", name)


def _traffic(name):
    return json.loads((REPO / "benchmark" / "traffic" / f"{name}.json")
                      .read_text())


def _key(reqs):
    return [(r["client"], r["n_text"], r["due"], r["seed"],
             tuple(r["ids"].tolist())) for r in reqs]


def test_same_seed_same_schedule():
    for mix in ("closed_long", "stream_poisson_short"):
        t = _traffic(mix)
        k = _kind(t["kind"])
        assert _key(k.plan(t, 2 ** 31 + 5, 51)) == \
            _key(k.plan(t, 2 ** 31 + 5, 51))
        assert _key(k.plan(t, 2 ** 31 + 5, 51)) != \
            _key(k.plan(t, 2 ** 31 + 6, 51))


def test_open_loop_count_gaps_and_lengths():
    t = _traffic("stream_poisson_short")
    k = _kind("open_poisson")
    a, b = k.plan(t, 7, 51), k.plan(t, 123456789012, 51)
    n = round(t["rate_per_s"] * 51)
    assert len(a) == len(b) == n
    assert all(0 < r["due"] < 51 for r in a + b)
    assert all(r["stream"] for r in a)
    # the same multiset of lengths and gaps, in another order
    assert Counter(r["n_text"] for r in a) == Counter(r["n_text"] for r in b)
    lo, hi = t["n_text"]["min"], t["n_text"]["max"]
    assert all(lo <= r["n_text"] <= hi and len(r["ids"]) == r["n_text"]
               for r in a)
    assert all(0 <= i < gen.TEXT_ID_LIMIT for r in a for i in r["ids"])
    gaps = lambda p: sorted(round(y["due"] - x["due"], 9)  # noqa: E731
                            for x, y in zip(p, p[1:]))
    assert gaps(a) != [] and abs(sum(gaps(a)) - sum(gaps(b))) < 1.0


def test_closed_loop_lengths_are_stratified():
    t = _traffic("closed_long")
    reqs = _kind("closed").plan(t, 99, 51)
    lo, hi = t["n_text"]["min"], t["n_text"]["max"]
    by_client = {}
    for r in reqs:
        by_client.setdefault(r["client"], []).append(r["n_text"])
    assert len(by_client) == t["clients"]
    for lens in by_client.values():
        # every block of hi - lo + 1 requests holds each length once
        block = lens[:hi - lo + 1]
        assert sorted(block) == list(range(lo, hi + 1))
    assert not any(r["stream"] for r in reqs)


def test_quantile_lengths_and_gaps():
    u = gen.quantile_lengths({"dist": "uniform", "min": 24, "max": 64}, 41)
    assert u == list(range(24, 65))
    ln = gen.quantile_lengths({"dist": "lognormal", "median": 12,
                               "sigma": 0.5, "min": 4, "max": 32}, 101)
    assert ln[50] == 12 and min(ln) >= 4 and max(ln) <= 32
    g = gen.exponential_gaps(50, 10.0)
    assert abs(sum(g) - 10.0) < 1e-9 and g == sorted(g)
