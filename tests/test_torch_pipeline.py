"""The port's continuous batcher at pipeline_depth=2 (chunk k+1
dispatched before chunk k is harvested) on the CPU at tiny geometry:
against its own depth 1, and against the JAX batcher at depth 2.

Depth 2 must not change a result: a request's codes depend only on its
seed, so every test holds depth 2 to depth 1 (or to JAX) bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qwen3_tts_tpu import config as C
from qwen3_tts_tpu.io import weights as jweights
from qwen3_tts_tpu.serve import batching as jbatching
from qwen3_tts_tpu_torch import config as pconfig
from qwen3_tts_tpu_torch.io import weights as tweights
from qwen3_tts_tpu_torch.serve.batching import ContinuousBatcher

torch.set_num_threads(1)

TINY = pconfig.tiny_tts_config(max_tokens=8)
TEXTS = ["abc", "defg", "hi", "jklmn", "op"]
GREEDY = C.SamplingConfig(temperature=0.0, repetition_penalty=1.0,
                          cp_temperature=0.0)


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
    assert all(f.done() for f in futs)
    return [f.result(timeout=1) for f in futs]


def _batcher(params, depth, **kw):
    return ContinuousBatcher(TINY, params, batch_size=2, decode_chunk=4,
                             dtype=torch.float32, device="cpu",
                             pipeline_depth=depth, **kw)


@pytest.fixture(scope="module")
def params():
    return tweights.init_random_params(TINY, seed=0, dtype=torch.float32)


@pytest.mark.parametrize("paged", [False, True])
def test_depth2_matches_depth1(params, paged):
    """Five requests through two slots (slots recycled), request 1
    streaming: depth 2 gives depth 1's codes and audio bit for bit, and
    the streaming request's segments make up its audio at both depths;
    every slot and page is free afterwards."""
    kw = dict(paged=True, page_size=8) if paged else {}
    res = {}
    for depth in (1, 2):
        b = _batcher(params, depth, **kw)
        segs = []
        futs = [b.submit(*_ids(t), seed=i,
                         on_chunk=segs.append if i == 1 else None)
                for i, t in enumerate(TEXTS)]
        res[depth] = _drain(b, futs)
        np.testing.assert_array_equal(np.concatenate(segs),
                                      res[depth][1][1])
        assert all(r is None for r in b._slot_req)
        if paged:
            assert len(b._free_pages) == b.pool_pages - 1
            assert int(b._state.kv.table.abs().sum()) == 0
    for (c1, a1), (c2, a2) in zip(res[1], res[2]):
        np.testing.assert_array_equal(c1, c2)
        np.testing.assert_array_equal(a1, a2)


def test_depth2_paged_budget(params):
    """Depth 2 over the paged pool: a request capped at 2 tokens stops
    there, and its neighbour decodes what it decodes alone at depth 1."""
    b = _batcher(params, 2, paged=True, page_size=8)
    ids, n = _ids("budgeted")
    ids2, n2 = _ids("full len")
    (c1, a1), (c2, a2) = _drain(b, [b.submit(ids, n, seed=3, max_tokens=2),
                                    b.submit(ids2, n2, seed=4)])
    assert len(c1) == 2 and len(a1) == 2 * 1920
    assert len(a2) == len(c2) * 1920
    (c_ref, _), = _solo(params, ids2, n2, 4)
    np.testing.assert_array_equal(c2, c_ref)


def _solo(params, ids, n, seed):
    b = _batcher(params, 1)
    return _drain(b, [b.submit(ids, n, seed=seed)])


@pytest.mark.parametrize("depth", [1, 2])
def test_cancel_admitted_request_frees_slot(params, depth):
    """A cancelled admitted request fails at the next chunk boundary, a
    queued request takes its slot, and the request beside it decodes
    what it decodes alone."""
    (codes_ref, audio_ref), = _solo(params, *_ids("survivor"), 7)
    b = _batcher(params, depth)
    f_surv = b.submit(*_ids("survivor"), seed=7)
    f_dead = b.submit(*_ids("doomed"), seed=8)
    f_next = b.submit(*_ids("queued"), seed=9)
    b.step()
    f_dead.request.cancelled = True
    for _ in range(400):
        if f_surv.done() and f_dead.done() and f_next.done():
            break
        b.step()
    with pytest.raises(RuntimeError, match="cancelled"):
        f_dead.result(timeout=1)
    codes, audio = f_surv.result(timeout=1)
    np.testing.assert_array_equal(codes, codes_ref)
    np.testing.assert_array_equal(audio, audio_ref)
    c_next, a_next = f_next.result(timeout=1)
    assert len(c_next) > 0 and len(a_next) == len(c_next) * 1920


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items() if k != "layers_list"}
    return np.asarray(tree)


def _pcfg(jcfg):
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


def test_depth2_matches_jax_depth2():
    """The same five requests through two slots at depth 2 in the JAX
    batcher and the port's (f32, greedy, f32 code predictor): every
    request's codes bit-equal, as test_torch_batching holds depth 1."""
    jcfg = dataclasses.replace(C.tiny_tts_config(max_tokens=8),
                               sampling=GREEDY)
    jp = jweights.init_random_params(jcfg, seed=0, dtype=jnp.float32)
    tp = tweights.from_jax_numpy(_np(jp))
    kw = dict(batch_size=2, decode_chunk=4, pipeline_depth=2,
              quantize_cp=False)
    jb = jbatching.ContinuousBatcher(jcfg, jp, dtype=jnp.float32, **kw)
    tb = ContinuousBatcher(_pcfg(jcfg), tp, dtype=torch.float32,
                           device="cpu", **kw)
    out = []
    for b in (jb, tb):
        out.append(_drain(b, [b.submit(*_ids(t), seed=i)
                              for i, t in enumerate(TEXTS)]))
    for (jc, ja), (tc, ta) in zip(*out):
        np.testing.assert_array_equal(tc, np.asarray(jc))
        assert len(ta) == len(np.asarray(ja)) == len(tc) * 1920
