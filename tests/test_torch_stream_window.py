"""The port engine's window streaming (``QWEN3_TTS_ENGINE_STREAM=window``,
the default) and its chained non-streaming vocoder, on the CPU at tiny
geometry, int8 and bf16:

- a streamed request gives the non-streaming request's codes and its
  ``audio_int16`` bit for bit, as the JAX engine's default stream does
  (tests/test_engine.py), and its on_chunk pieces concatenate to it; an
  EOS inside the first head chunk, ``max_tokens=1``, no consumer, and
  ``first_audio_seconds`` None without tokens;
- ``QWEN3_TTS_ENGINE_STREAM=incremental`` keeps the incremental stream's
  contract (int16 within +-1 LSB), and an unknown mode raises;
- the chained request (the vocoder launched on the device codes buffer
  before the fetch) equals fetch-then-``synthesize_exact`` bit for bit,
  also at the widest vocoder bucket;
- ``_pacing_bound`` and ``_chained_voc_window`` equal the JAX engine's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from qwen3_tts_tpu import config as C
from qwen3_tts_tpu.engine import engine as jengine
from qwen3_tts_tpu_torch import config as pconfig
from qwen3_tts_tpu_torch.engine import engine as tengine
from qwen3_tts_tpu_torch.models import vocoder as tvoc

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def engines():
    """int8 (the kernels' plain versions) and bf16, max_tokens 80."""
    cfg = pconfig.tiny_tts_config(max_tokens=80)
    return {"int8": tengine.TTSEngine(cfg, quantize="int8", device="cpu"),
            "bf16": tengine.TTSEngine(cfg, device="cpu")}


# (engine, text, max_tokens): bf16 runs to its budget of 80, past the
# head chunks (the last decode call, the optimistic tail windows and the
# host window of the last token); int8 ends by EOS inside the second
# head chunk (~24 tokens)
CASES = [("bf16", "Hello from the port, twice over.", None),
         ("int8", "Hi there", 32)]
IDS = ["bf16-long", "int8-eos"]


@pytest.fixture(scope="module")
def plain(engines):
    """The chained non-streaming result of each case, computed once."""
    cache = {}

    def get(kind, text, cap):
        if (kind, text, cap) not in cache:
            cache[kind, text, cap] = engines[kind].synthesize(
                text, seed=1, max_tokens=cap)
        return cache[kind, text, cap]
    return get


def _stream(eng, text, **kw):
    pieces = []
    res = eng.synthesize(text, seed=1, streaming=True,
                         on_chunk=pieces.append, **kw)
    for p in pieces:
        assert p.dtype == np.int16 and len(p) > 0
    got = np.concatenate(pieces) if pieces else np.zeros((0,), np.int16)
    np.testing.assert_array_equal(got, res.audio_int16)
    return res, len(pieces)


@pytest.mark.parametrize("kind,text,cap", CASES, ids=IDS)
def test_window_stream_is_bit_equal(engines, plain, kind, text, cap):
    want = plain(kind, text, cap)
    assert want.n_tokens > 8 and want.first_audio_seconds is not None
    res, n_pieces = _stream(engines[kind], text, max_tokens=cap)
    np.testing.assert_array_equal(res.codes, want.codes)
    np.testing.assert_array_equal(res.audio_int16, want.audio_int16)
    assert n_pieces >= 2 and res.first_audio_seconds is not None
    if kind == "bf16":
        assert want.n_tokens == 80          # the budget, past the head
    else:
        assert want.n_tokens < 32           # EOS in the second head chunk


@pytest.mark.parametrize("kind,text,cap", CASES, ids=IDS)
def test_window_stream_without_a_consumer(engines, plain, kind, text, cap):
    """No on_chunk: the head reads no status (rows past an EOS are zero
    codes, trimmed at the end), and the audio is the same bits."""
    want = plain(kind, text, cap)
    res = engines[kind].synthesize(text, seed=1, streaming=True,
                                   max_tokens=cap)
    np.testing.assert_array_equal(res.codes, want.codes)
    np.testing.assert_array_equal(res.audio_int16, want.audio_int16)
    assert res.first_audio_seconds is not None


@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_window_eos_inside_first_head_chunk(engines, plain, kind):
    want = plain(kind, "ab", None)
    assert 0 < want.n_tokens < 8
    res, n_pieces = _stream(engines[kind], "ab")
    np.testing.assert_array_equal(res.codes, want.codes)
    np.testing.assert_array_equal(res.audio_int16, want.audio_int16)
    assert n_pieces == 1
    assert len(res.audio_int16) == res.n_tokens * 1920


@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_window_max_tokens_one(engines, plain, kind):
    """One token: no head window holds a kept token (its lookahead is not
    decoded), so the host window past the buffer renders it."""
    want = plain(kind, "Привет", 1)
    res, n_pieces = _stream(engines[kind], "Привет", max_tokens=1)
    assert res.n_tokens == want.n_tokens == 1 and n_pieces == 1
    np.testing.assert_array_equal(res.codes, want.codes)
    np.testing.assert_array_equal(res.audio_int16, want.audio_int16)
    assert len(res.audio_int16) == 1920
    assert res.first_audio_seconds is not None


@pytest.mark.parametrize("path", ["window", "chained", "unchained"])
def test_first_audio_is_none_without_tokens(engines, monkeypatch, path):
    """A decode that ends before its first token (EOS at step 0): no
    audio, no pieces, and first_audio_seconds is None."""
    def run_steps(tp, cpp, state, cfg, steps, mesh=None):
        return dataclasses.replace(state, done=torch.ones_like(state.done))
    monkeypatch.setattr(tengine.gen, "run_steps", run_steps)
    eng = engines["bf16"]
    monkeypatch.setattr(eng, "_chained_vocode", path != "unchained")
    pieces = []
    res = eng.synthesize("Привет", seed=1, streaming=path == "window",
                         on_chunk=pieces.append)
    assert res.n_tokens == 0 and len(res.audio_int16) == 0
    assert res.codes.shape == (0, 16)
    assert res.first_audio_seconds is None and pieces == []


def test_incremental_mode_keeps_its_contract(engines, plain, monkeypatch):
    """QWEN3_TTS_ENGINE_STREAM=incremental: the incremental vocoder
    stream, int16 within +-1 LSB on < 0.01% of samples."""
    kind, text, cap = CASES[1]
    want = plain(kind, text, cap)
    monkeypatch.setenv("QWEN3_TTS_ENGINE_STREAM", "incremental")
    res, n_pieces = _stream(engines[kind], text, max_tokens=cap)
    np.testing.assert_array_equal(res.codes, want.codes)
    d = np.abs(res.audio_int16.astype(np.int32)
               - want.audio_int16.astype(np.int32))
    assert d.max() <= 1 and float((d > 0).mean()) < 1e-4
    assert n_pieces >= 2


def test_unknown_stream_mode_raises(engines, monkeypatch):
    monkeypatch.setenv("QWEN3_TTS_ENGINE_STREAM", "chunky")
    with pytest.raises(ValueError, match="QWEN3_TTS_ENGINE_STREAM"):
        engines["bf16"].synthesize("ab", streaming=True)


@pytest.mark.parametrize("kind,text,cap,widest",
                         [(*CASES[0], False), (*CASES[1], True)],
                         ids=["bf16-long-bound", "int8-eos-widest"])
def test_chained_equals_unchained(engines, plain, monkeypatch, kind, text,
                                  cap, widest):
    """The chain's window against fetch-then-synthesize_exact (a window of
    voc_bucket(n + 1)): equal codes and audio bit for bit. bf16 at the
    pacing bound's bucket (128 tokens, zero-padded past the 80-row
    buffer); int8 at the widest bucket (320 against 64: the zero rows
    past n change nothing)."""
    eng = engines[kind]
    if widest:
        monkeypatch.setattr(tengine, "_chained_voc_window",
                            lambda *a: tvoc.VOC_BUCKETS[-1])
        got = eng.synthesize(text, seed=1, max_tokens=cap)
    else:
        got = plain(kind, text, cap)
    assert set(got.timings) == {"tokenize", "decode+vocoder"}
    monkeypatch.setattr(eng, "_chained_vocode", False)
    want = eng.synthesize(text, seed=1, max_tokens=cap)
    assert set(want.timings) == {"tokenize", "decode", "vocoder"}
    np.testing.assert_array_equal(got.codes, want.codes)
    np.testing.assert_array_equal(got.audio_int16, want.audio_int16)


# (budget, n_text, SamplingConfig changes) from tests/test_engine.py
WINDOW_CASES = [(200, 0, None), (10, 0, None), (200, 5, None),
                (20, 50, None), (200, 5, {}), (200, 5, {
                    "expected_tokens_per_text_token": 4}),
                (200, 0, {"expected_tokens_per_text_token": 4}),
                (10, 50, {}), (200, 7, {"eos_force_progress": 1.5})]


@pytest.mark.parametrize("budget,n_text,change", WINDOW_CASES)
def test_window_sizing_matches_jax(budget, n_text, change):
    """The pacing bound and the chained window against the JAX engine's
    own functions (plain Python: importing the module compiles
    nothing)."""
    if change is None:
        js = ps = None
    else:
        js = dataclasses.replace(C.SamplingConfig(), **change)
        ps = dataclasses.replace(pconfig.SamplingConfig(), **change)
    assert (tengine._pacing_bound(budget, n_text, ps)
            == jengine._pacing_bound(budget, n_text, js))
    assert (tengine._chained_voc_window(budget, n_text, ps)
            == jengine._chained_voc_window(budget, n_text, js))
