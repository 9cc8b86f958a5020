"""The port engine's prefix-state cache, on the CPU at tiny geometry: the
LRU of post-prefill states (``_prefix_cache``, 4 entries) and the disk
snapshots under ``kv_cache_dir``, against the JAX engine's (f32, greedy,
the same weights).

- A hit gives the cold request's codes; eviction holds the cap.
- A, B, A: the two A's give equal codes (JAX's), and the snapshot stays
  what a fresh prefill gives: the loop updates the KV cache and the codes
  buffer in place, so a request must decode a copy.
- A hit takes the request's seed and token cap, a streaming hit its codes.
- Disk: a round trip, a corrupt file (recomputed), a file without
  ``budget``; and the file one engine writes, the other reads, each
  giving the writer's greedy codes.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qwen3_tts_tpu import config as C
from qwen3_tts_tpu.engine import engine as jengine
from qwen3_tts_tpu.io import weights as jweights
from qwen3_tts_tpu_torch import config as pconfig
from qwen3_tts_tpu_torch.engine import engine as tengine
from qwen3_tts_tpu_torch.io import weights as tweights

torch.set_num_threads(1)

GREEDY = C.SamplingConfig(temperature=0.0, repetition_penalty=1.0,
                          cp_temperature=0.0)
JCFG = dataclasses.replace(C.tiny_tts_config(max_tokens=8), sampling=GREEDY)
PCFG = dataclasses.replace(
    pconfig.tiny_tts_config(max_tokens=8),
    sampling=pconfig.SamplingConfig(**dataclasses.asdict(GREEDY)))


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items() if k != "layers_list"}
    return np.asarray(tree)


@pytest.fixture(scope="module")
def weights():
    jp = jweights.init_random_params(JCFG, seed=1, dtype=jnp.float32)
    return jp, tweights.from_jax_numpy(_np(jp))


@pytest.fixture(scope="module")
def jax_engine(weights, tmp_path_factory):
    """The JAX engine, always through its disk path (one set of
    programs: prefill, decode, vocoder)."""
    eng = jengine.TTSEngine(JCFG, params=weights[0], dtype=jnp.float32)
    eng.kv_cache_dir = str(tmp_path_factory.mktemp("jax_kv"))
    return eng


@pytest.fixture(scope="module")
def port(weights):
    return tengine.TTSEngine(PCFG, params=weights[1], dtype=torch.float32,
                             device="cpu")


@pytest.fixture
def fresh(port):
    """The greedy port engine with an empty cache and no disk dir."""
    port._prefix_cache.clear()
    port.kv_cache_dir = None
    yield port
    port.kv_cache_dir = None


def _files(d):
    return sorted(f for f in os.listdir(d) if f.startswith("qwen3_kv_"))


def _no_prefill(eng, monkeypatch):
    """Make the port engine fail if it prefills (it must restore)."""
    def boom(*a, **k):
        raise AssertionError("prefilled instead of restoring")
    monkeypatch.setattr(eng, "_prefill_state", boom)


def test_hit_gives_equal_codes_and_eviction_holds_cap(fresh):
    a = fresh.synthesize("repeat me", seed=9)
    assert len(fresh._prefix_cache) == 1
    b = fresh.synthesize("repeat me", seed=9)
    np.testing.assert_array_equal(a.codes, b.codes)
    np.testing.assert_array_equal(a.audio_int16, b.audio_int16)
    cap = fresh._prefix_cache_cap
    assert cap == 4
    for i in range(cap + 2):
        fresh.synthesize(f"text {i}", seed=0)
    assert len(fresh._prefix_cache) == cap
    ids, n = fresh._encode_text("repeat me")
    assert (tuple(ids.tolist()), n) not in fresh._prefix_cache
    ids, n = fresh._encode_text(f"text {cap + 1}")
    assert (tuple(ids.tolist()), n) in fresh._prefix_cache


def test_a_b_a_keeps_the_snapshot(fresh, jax_engine):
    """A, B, A: both A's give the JAX engine's greedy codes, and A's
    cached state still equals a fresh prefill, field by field."""
    want = np.asarray(jax_engine.synthesize("text A", language="english",
                                            seed=0).codes)
    a1 = fresh.synthesize("text A", seed=0)
    fresh.synthesize("another text B", seed=0)
    a2 = fresh.synthesize("text A", seed=0)
    np.testing.assert_array_equal(a1.codes, want)
    np.testing.assert_array_equal(a2.codes, want)
    np.testing.assert_array_equal(a1.audio_int16, a2.audio_int16)
    ids, n = fresh._encode_text("text A")
    snap = fresh._prefix_cache[(tuple(ids.tolist()), n)]
    clean = fresh._prefill_state(ids, n, n)
    for f in dataclasses.fields(snap):
        if f.name != "key":
            torch.testing.assert_close(getattr(snap, f.name),
                                       getattr(clean, f.name), rtol=0,
                                       atol=0, msg=f.name)


def test_hit_takes_the_request_seed_cap_and_stream(weights):
    """Sampled: a hit under seed 5 equals the cold seed-5 request; a hit
    under max_tokens=3 stops there with the cold request's first codes; a
    streaming hit gives the whole request's codes."""
    eng = tengine.TTSEngine(pconfig.tiny_tts_config(max_tokens=8),
                            params=weights[1], dtype=torch.float32,
                            device="cpu")
    r0 = eng.synthesize("seeded text", seed=0)
    hit5 = eng.synthesize("seeded text", seed=5)
    capped = eng.synthesize("seeded text", seed=0, max_tokens=3)
    pieces = []
    streamed = eng.synthesize("seeded text", seed=0, streaming=True,
                              on_chunk=pieces.append)
    assert len(eng._prefix_cache) == 1
    eng._prefix_cache.clear()
    cold5 = eng.synthesize("seeded text", seed=5)
    np.testing.assert_array_equal(hit5.codes, cold5.codes)
    assert not np.array_equal(hit5.codes, r0.codes)
    assert 1 <= capped.n_tokens <= 3
    np.testing.assert_array_equal(capped.codes, r0.codes[:capped.n_tokens])
    np.testing.assert_array_equal(streamed.codes, r0.codes)
    np.testing.assert_array_equal(np.concatenate(pieces),
                                  streamed.audio_int16)


def test_disk_round_trip(fresh, tmp_path, monkeypatch):
    fresh.kv_cache_dir = str(tmp_path)
    a = fresh.synthesize("disk cached", seed=4)
    assert len(_files(tmp_path)) == 1
    fresh._prefix_cache.clear()
    with monkeypatch.context() as m:
        _no_prefill(fresh, m)
        b = fresh.synthesize("disk cached", seed=4)
    np.testing.assert_array_equal(a.codes, b.codes)
    np.testing.assert_array_equal(a.audio_int16, b.audio_int16)
    assert len(_files(tmp_path)) == 1


def test_corrupt_file_is_recomputed(fresh, tmp_path):
    fresh.kv_cache_dir = str(tmp_path)
    a = fresh.synthesize("corrupt me", seed=1)
    (path,) = _files(tmp_path)
    (tmp_path / path).write_bytes(b"garbage")
    fresh._prefix_cache.clear()
    b = fresh.synthesize("corrupt me", seed=1)
    np.testing.assert_array_equal(a.codes, b.codes)


def test_file_without_budget_loads(fresh, tmp_path, monkeypatch):
    fresh.kv_cache_dir = str(tmp_path)
    a = fresh.synthesize("legacy fmt", seed=6)
    (name,) = _files(tmp_path)
    path = str(tmp_path / name)
    with np.load(path) as f:
        data = dict(f)
    assert {"budget", "step"} <= set(data)
    data.pop("budget")
    np.savez(path, **data)
    fresh._prefix_cache.clear()
    _no_prefill(fresh, monkeypatch)
    b = fresh.synthesize("legacy fmt", seed=6)
    np.testing.assert_array_equal(a.codes, b.codes)


def test_snapshot_read_across_engines(fresh, jax_engine, tmp_path,
                                      monkeypatch):
    """The JAX engine writes, the port reads (it may not prefill), and
    the reverse (the JAX engine may not run its prefill program): each
    reader gives the writer's greedy codes, from the one file."""
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    pdir.mkdir()
    jax_engine._prefix_cache.clear()
    jax_engine.kv_cache_dir = str(jdir)
    want = np.asarray(jax_engine.synthesize("written by jax",
                                            language="english",
                                            seed=0).codes)
    assert len(_files(jdir)) == 1
    fresh.kv_cache_dir = str(jdir)
    with monkeypatch.context() as m:
        _no_prefill(fresh, m)
        got = fresh.synthesize("written by jax", seed=0)
    np.testing.assert_array_equal(got.codes, want)
    assert len(_files(jdir)) == 1

    fresh.kv_cache_dir = str(pdir)
    want = fresh.synthesize("written by the port", seed=0).codes
    assert len(_files(pdir)) == 1
    jax_engine._prefix_cache.clear()
    jax_engine.kv_cache_dir = str(pdir)

    def boom(*a, **k):
        raise AssertionError("prefilled instead of restoring")
    monkeypatch.setattr(jax_engine, "_init_state", boom)
    got = np.asarray(jax_engine.synthesize("written by the port",
                                           language="english",
                                           seed=0).codes)
    np.testing.assert_array_equal(got, want)
    assert len(_files(pdir)) == 1
