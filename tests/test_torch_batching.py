"""The port's continuous batcher (qwen3_tts_tpu_torch.serve.batching) on
the CPU at tiny geometry: against the JAX ContinuousBatcher, dense and
paged, and on its own (plain kernel versions, int8 code predictor,
sampled draws).

Against JAX both sides run f32 and greedy (temperature 0, cp_temperature
0), attention_impl "xla" and an f32 code predictor, so that only the
scheduler and the attention paths are compared: each request's codes
must be bit-equal.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qwen3_tts_tpu import config as C
from qwen3_tts_tpu.io import weights as jweights
from qwen3_tts_tpu.serve import batching as jbatching
from qwen3_tts_tpu_torch import config as pconfig
from qwen3_tts_tpu_torch.engine import generate as tgen
from qwen3_tts_tpu_torch.io import weights as tweights
from qwen3_tts_tpu_torch.models import talker as ttk
from qwen3_tts_tpu_torch.ops import sampling as tsmp
from qwen3_tts_tpu_torch.parallel import mesh as pmesh
from qwen3_tts_tpu_torch.serve import batching as tbatching

torch.set_num_threads(1)

GREEDY = C.SamplingConfig(temperature=0.0, repetition_penalty=1.0,
                          cp_temperature=0.0)
TEXTS = ["abc", "defg", "hi", "jklmn", "op"]


def _pcfg(jcfg):
    """The port's twin of a JAX TTSConfig (the fields are held equal by
    tests/test_torch_modules.py)."""
    def part(cls, obj):
        return cls(**{f.name: getattr(obj, f.name)
                      for f in dataclasses.fields(cls)})
    return pconfig.TTSConfig(
        talker=part(pconfig.TalkerConfig, jcfg.talker),
        code_predictor=part(pconfig.CodePredictorConfig,
                            jcfg.code_predictor),
        vocoder=part(pconfig.VocoderConfig, jcfg.vocoder),
        sampling=part(pconfig.SamplingConfig, jcfg.sampling),
        max_tokens=jcfg.max_tokens)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items() if k != "layers_list"}
    return np.asarray(tree)


def _ids(text, n=8):
    arr = np.zeros(n, np.int32)
    raw = [ord(c) % 1000 for c in text][:n]
    arr[:len(raw)] = raw
    return arr, len(raw)


def _drain(b, futs, limit=600):
    for _ in range(limit):
        if all(f.done() for f in futs):
            break
        b.step()
    return [f.result(timeout=1) for f in futs]


def _serve_both(jcfg, jp, tp, requests, **kw):
    """The same requests through the JAX batcher and the port's, in the
    same order. Returns (jax results, port results, port batcher)."""
    jb = jbatching.ContinuousBatcher(jcfg, jp, dtype=jnp.float32,
                                     quantize_cp=False, **kw)
    tb = tbatching.ContinuousBatcher(_pcfg(jcfg), tp, dtype=torch.float32,
                                     quantize_cp=False, device="cpu", **kw)
    out = []
    for b in (jb, tb):
        futs = [b.submit(ids, n, seed=i) for i, (ids, n) in
                enumerate(requests)]
        out.append(_drain(b, futs))
    return out[0], out[1], tb


def test_dense_batcher_matches_jax():
    """5 requests through 2 slots: every request's codes bit-equal to the
    JAX batcher's (also after its slot was recycled), n * 1920 samples of
    int16 audio, all slots free."""
    jcfg = dataclasses.replace(C.tiny_tts_config(max_tokens=8),
                               sampling=GREEDY)
    jp = jweights.init_random_params(jcfg, seed=0, dtype=jnp.float32)
    tp = tweights.from_jax_numpy(_np(jp))
    want, got, tb = _serve_both(jcfg, jp, tp, [_ids(t) for t in TEXTS],
                                batch_size=2, decode_chunk=4)
    for (jc, ja), (tc, ta) in zip(want, got):
        np.testing.assert_array_equal(tc, np.asarray(jc))
        assert ta.dtype == np.int16 and len(ta) == len(tc) * 1920
        assert len(np.asarray(ja)) == len(ta)
    assert all(r is None for r in tb._slot_req)
    assert bool(tb._state.done.all())


def test_paged_batcher_matches_jax_past_the_dense_cap():
    """The paged batcher (max_seq_len 64, max_tokens 100, pages of 16):
    a 30-token request generates past the dense allocation, its codes
    bit-equal to the JAX paged batcher's, and every page is recycled.
    The weights' seed gives no greedy near-tie between K4's split
    softmax and JAX's gather-then-softmax (they differ by f32
    rounding)."""
    base = dataclasses.replace(C.tiny_tts_config(max_tokens=100),
                               sampling=GREEDY)
    jcfg = dataclasses.replace(
        base, talker=dataclasses.replace(base.talker, max_seq_len=64))
    jp = jweights.init_random_params(jcfg, seed=0, dtype=jnp.float32)
    tp = tweights.from_jax_numpy(_np(jp))
    long_ids = np.arange(1000, 1030, dtype=np.int32)
    reqs = [(long_ids, 30), (np.arange(700, 712, dtype=np.int32), 12)]
    want, got, tb = _serve_both(jcfg, jp, tp, reqs, batch_size=2,
                                decode_chunk=8, paged=True, page_size=16)
    dense_cap = jcfg.talker.max_seq_len - 1 - (30 + ttk.PREFIX_EXTRA)
    assert len(got[0][0]) > dense_cap, (len(got[0][0]), dense_cap)
    for (jc, _), (tc, ta) in zip(want, got):
        np.testing.assert_array_equal(tc, np.asarray(jc))
        assert len(ta) == len(tc) * 1920
    assert tb._slot_pages == [[], []]
    assert len(tb._free_pages) == tb.pool_pages - 1
    assert int(tb._state.kv.capacity.abs().sum()) == 0
    assert int(tb._state.kv.table.abs().sum()) == 0


# ---------------------------------------------------------------------------
# the port's batcher on its own: int8 code predictor (K2's plain version),
# sampled draws
# ---------------------------------------------------------------------------

TINY = pconfig.tiny_tts_config(max_tokens=8)


@pytest.fixture(scope="module")
def params():
    return tweights.init_random_params(TINY, seed=0, dtype=torch.float32)


@pytest.fixture(scope="module")
def batcher(params):
    return tbatching.ContinuousBatcher(TINY, params, batch_size=2,
                                       decode_chunk=4, dtype=torch.float32,
                                       device="cpu")


def test_batched_slot_matches_solo_synthesis(batcher):
    """A request admitted into a busy batch gives exactly the codes of a
    solo batch-1 decode with the same seed (its key rides with the
    slot), and a resubmission reproduces them."""
    ids, n = _ids("parity")
    seed = 77
    tp, cpp = batcher._tp, batcher._cpp
    prefix, plen = ttk.build_prefix(tp, torch.from_numpy(ids), n)
    with torch.inference_mode():
        codes_solo, n_solo = tgen.generate(
            tp, cpp, prefix[None], plen[None], torch.tensor([n]),
            tsmp.batch_keys([seed], 1), TINY)
    n_solo = int(n_solo[0])

    f_other = batcher.submit(*_ids("noise"), seed=1)
    batcher.step()                 # the other request is mid-decode
    f = batcher.submit(ids, n, seed=seed)
    (codes, _), _ = _drain(batcher, [f, f_other])
    assert len(codes) == n_solo
    np.testing.assert_array_equal(codes, codes_solo[0, :n_solo].numpy())
    (again, _), = _drain(batcher, [batcher.submit(ids, n, seed=seed)])
    np.testing.assert_array_equal(again, codes)


def test_per_request_max_tokens_frees_slot(batcher):
    """A capped request stops at its budget within one chunk, and its
    codes are the prefix of the uncapped stream of the same seed."""
    ids, n = _ids("capped")
    (full, _), = _drain(batcher, [batcher.submit(ids, n, seed=5)])
    assert len(full) > 2
    f_cap = batcher.submit(ids, n, seed=5, max_tokens=2)
    batcher.step()
    assert f_cap.done(), "capped slot still busy after its budget"
    codes, audio = f_cap.result(timeout=1)
    assert len(codes) == 2 and len(audio) == 2 * 1920
    np.testing.assert_array_equal(codes, full[:2])


def test_background_thread(batcher):
    batcher.start()
    try:
        codes, audio = batcher.submit(*_ids("thread"), seed=42).result(
            timeout=120)
        assert len(audio) == len(codes) * 1920
    finally:
        batcher.stop()
    assert batcher.occupancy()["active_slots"] == 0


def test_stop_drains_in_flight_and_fails_queued(params):
    """stop(drain=True): in-flight requests finish, queued ones fail with
    RuntimeError; stop(drain=False) before start fails every request."""
    b = tbatching.ContinuousBatcher(TINY, params, batch_size=2,
                                    decode_chunk=4, dtype=torch.float32,
                                    device="cpu")
    ids, n = _ids("drain me")
    b.start()
    try:
        in_flight = [b.submit(ids, n, seed=i) for i in range(2)]
        deadline = time.time() + 60
        while any(r is None for r in b._slot_req) and time.time() < deadline:
            time.sleep(0.01)
        queued = [b.submit(ids, n, seed=9)]
    finally:
        b.stop(drain=True, timeout=120)
    for f in in_flight:
        codes, _ = f.result(timeout=0)
        assert len(codes) > 0
    for f in queued:
        with pytest.raises(RuntimeError, match="batcher stopped"):
            f.result(timeout=0)
    futs = [b.submit(ids, n, seed=i) for i in range(3)]
    b.stop(drain=False)
    for f in futs:
        with pytest.raises(RuntimeError, match="batcher stopped"):
            f.result(timeout=0)


def test_prefix_that_cannot_fit_fails_instead_of_wedging(params):
    """A prefix past a slot's page capacity, or past every usable page of
    the pool, fails its own Future; the request behind it is served and
    the pool recycled. The dense batcher refuses a prefix past
    max_seq_len the same way."""
    b = tbatching.ContinuousBatcher(
        TINY, params, batch_size=1, decode_chunk=4, dtype=torch.float32,
        device="cpu", paged=True, page_size=16, max_pages_per_slot=2)
    f_bad = b.submit(np.arange(100, 140, dtype=np.int32), 40, seed=1)
    f_ok = b.submit(np.arange(200, 212, dtype=np.int32), 12, seed=2)
    _drain(b, [f_ok])
    with pytest.raises(ValueError, match="page capacity"):
        f_bad.result(timeout=1)
    assert len(b._free_pages) == b.pool_pages - 1

    b = tbatching.ContinuousBatcher(
        TINY, params, batch_size=1, decode_chunk=4, dtype=torch.float32,
        device="cpu", paged=True, page_size=16, pool_pages=3)
    f_bad = b.submit(np.arange(100, 130, dtype=np.int32), 30, seed=1)
    f_ok = b.submit(np.arange(5, dtype=np.int32), 5, seed=2)
    _drain(b, [f_ok])
    with pytest.raises(ValueError, match="usable pages"):
        f_bad.result(timeout=1)
    assert len(b._free_pages) == 2

    b = tbatching.ContinuousBatcher(TINY, params, batch_size=1,
                                    decode_chunk=4, dtype=torch.float32,
                                    device="cpu")
    f_bad = b.submit(np.arange(1, 130, dtype=np.int32), 129, seed=1)
    b.step()
    with pytest.raises(ValueError, match="dense KV allocation"):
        f_bad.result(timeout=1)


def test_backpressure_and_refusals(params):
    """max_queue raises OverloadedError. Streaming (on_chunk), once
    refused here, is ported: the request is served and its segments make
    up its audio. Voice cloning, once refused here too, is ported:
    ref_codes without n_target (or the reverse) is a ValueError, as in
    the JAX batcher. A device mesh, once refused here too, is ported: a
    batch size that the mesh's dp does not divide is the JAX batcher's
    ValueError."""
    b = tbatching.ContinuousBatcher(TINY, params, batch_size=1,
                                    dtype=torch.float32, device="cpu",
                                    max_queue=1)
    ids, n = _ids("x")
    f = b.submit(ids, n)
    with pytest.raises(tbatching.OverloadedError):
        b.submit(ids, n)
    _drain(b, [f])
    pieces = []
    (codes, audio), = _drain(b, [b.submit(ids, n, on_chunk=pieces.append)])
    assert len(codes) > 0 and len(audio) == len(codes) * 1920
    np.testing.assert_array_equal(np.concatenate(pieces), audio)
    with pytest.raises(ValueError, match="go together"):
        b.submit(ids, n, ref_codes=np.zeros((4, 16)))
    with pytest.raises(ValueError, match="go together"):
        b.submit(ids, n, n_target=1)
    with pytest.raises(ValueError, match="not divisible by dp 2"):
        tbatching.ContinuousBatcher(TINY, params, batch_size=3,
                                    mesh=pmesh.make_mesh(2, 1, ["cpu"] * 2))
