"""Streaming synthesis in the port's TTSEngine (``streaming=True``,
``on_chunk``) in its incremental mode (``QWEN3_TTS_ENGINE_STREAM=
incremental``, on models/vocoder_stream; the default window mode is
tests/test_torch_stream_window.py's), on the CPU at tiny geometry, int8
and bf16:

- the pieces handed to on_chunk concatenate to ``audio_int16``; the
  codes equal the non-streaming request's (the same request decoded in
  one run_steps call and in head chunks of 8, 56 and the rest), and the
  audio is within the stream contract of tests/test_vocoder_stream.py
  (int16 within +-1 LSB on < 0.01% of samples);
- an EOS inside the first head chunk, ``max_tokens=1``, and
  ``first_audio_seconds`` set exactly when a token was generated.
"""

import dataclasses

import numpy as np
import pytest
import torch

from qwen3_tts_tpu_torch import config as pconfig
from qwen3_tts_tpu_torch.engine import engine as tengine

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def engines():
    """int8 (the kernels' plain versions) and bf16, max_tokens 80."""
    cfg = pconfig.tiny_tts_config(max_tokens=80)
    return {"int8": tengine.TTSEngine(cfg, quantize="int8", device="cpu"),
            "bf16": tengine.TTSEngine(cfg, device="cpu")}


@pytest.fixture(autouse=True)
def incremental(monkeypatch):
    monkeypatch.setenv("QWEN3_TTS_ENGINE_STREAM", "incremental")


def _stream(eng, text, **kw):
    pieces = []
    res = eng.synthesize(text, seed=1, streaming=True,
                         on_chunk=pieces.append, **kw)
    for p in pieces:
        assert p.dtype == np.int16 and len(p) > 0
    got = np.concatenate(pieces) if pieces else np.zeros((0,), np.int16)
    np.testing.assert_array_equal(got, res.audio_int16)
    return res, len(pieces)


def _within_stream_contract(got, want):
    assert got.shape == want.shape
    delta = np.abs(got.astype(np.int32) - want.astype(np.int32))
    if len(delta):
        assert delta.max() <= 1 and float((delta > 0).mean()) < 1e-4


# (engine, text, max_tokens): past the head (the bf16 request runs to
# its budget of 80, so the last decode call and the steps up to the
# horizon run), and an EOS inside the second head chunk (int8, ~24
# tokens)
CASES = [("bf16", "Hello from the port, twice over.", None),
         ("int8", "Hi there", 32)]


@pytest.mark.parametrize("kind,text,cap", CASES, ids=["bf16", "int8"])
def test_streaming_matches_non_streaming(engines, kind, text, cap):
    eng = engines[kind]
    want = eng.synthesize(text, seed=1, max_tokens=cap)
    assert want.n_tokens > 8
    assert want.first_audio_seconds is not None
    res, n_pieces = _stream(eng, text, max_tokens=cap)
    np.testing.assert_array_equal(res.codes, want.codes)
    _within_stream_contract(res.audio_int16, want.audio_int16)
    assert n_pieces >= 2 and res.first_audio_seconds is not None
    if kind == "bf16":
        assert want.n_tokens == 80          # the budget, past the head


@pytest.mark.parametrize("kind,text,cap", CASES, ids=["bf16", "int8"])
def test_streaming_without_a_consumer(engines, kind, text, cap):
    """No on_chunk: the head reads no status (frames past an EOS are
    zeros, trimmed at the end), and the audio is the same."""
    eng = engines[kind]
    want = eng.synthesize(text, seed=1, max_tokens=cap)
    res = eng.synthesize(text, seed=1, streaming=True, max_tokens=cap)
    np.testing.assert_array_equal(res.codes, want.codes)
    _within_stream_contract(res.audio_int16, want.audio_int16)
    assert res.first_audio_seconds is not None


@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_eos_inside_first_head_chunk(engines, kind):
    eng = engines[kind]
    want = eng.synthesize("ab", seed=1)
    assert 0 < want.n_tokens < 8
    res, n_pieces = _stream(eng, "ab")
    np.testing.assert_array_equal(res.codes, want.codes)
    _within_stream_contract(res.audio_int16, want.audio_int16)
    assert n_pieces == 1


@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_max_tokens_one(engines, kind):
    eng = engines[kind]
    want = eng.synthesize("Привет", seed=1, max_tokens=1)
    res, n_pieces = _stream(eng, "Привет", max_tokens=1)
    assert res.n_tokens == want.n_tokens == 1 and n_pieces == 1
    np.testing.assert_array_equal(res.codes, want.codes)
    _within_stream_contract(res.audio_int16, want.audio_int16)
    assert len(res.audio_int16) == 1920
    assert res.first_audio_seconds is not None


@pytest.mark.parametrize("streaming", [False, True])
def test_first_audio_is_none_without_tokens(engines, monkeypatch,
                                            streaming):
    """A decode that ends before its first token (EOS at step 0): no
    audio, no pieces, and first_audio_seconds is None."""
    def run_steps(tp, cpp, state, cfg, steps, mesh=None):
        return dataclasses.replace(state, done=torch.ones_like(state.done))
    monkeypatch.setattr(tengine.gen, "run_steps", run_steps)
    pieces = []
    res = engines["bf16"].synthesize("Привет", seed=1, streaming=streaming,
                                     on_chunk=pieces.append)
    assert res.n_tokens == 0 and len(res.audio_int16) == 0
    assert res.codes.shape == (0, 16)
    assert res.first_audio_seconds is None and pieces == []
