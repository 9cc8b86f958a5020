"""TTSEngine.synthesize_long of the port (paragraph text in sentence
pieces: the first alone, the rest in batched groups), on the CPU at tiny
geometry (max_tokens 8, so the piece budget is 2 tokens):

- the result is its pieces' codes and audio in order, the on_chunk
  pieces make up the audio, one piece passes through to synthesize, all
  of a text past one request's cap is covered, bad arguments raise;
- with and without on_chunk: equal codes, audio within +-1 LSB (the
  first piece is streamed);
- greedy, f32: the JAX engine's synthesize_long codes on one paragraph.
"""

import dataclasses

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
from qwen3_tts_tpu_torch.utils.text import (piece_token_budget,
                                            split_for_budget)

torch.set_num_threads(1)

GREEDY = C.SamplingConfig(temperature=0.0, repetition_penalty=1.0,
                          cp_temperature=0.0)
JCFG = dataclasses.replace(C.tiny_tts_config(max_tokens=8), sampling=GREEDY)
PCFG = dataclasses.replace(
    pconfig.tiny_tts_config(max_tokens=8),
    sampling=pconfig.SamplingConfig(**dataclasses.asdict(GREEDY)))
TEXT = "ab cd. ef gh"


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items() if k != "layers_list"}
    return np.asarray(tree)


@pytest.fixture(scope="module")
def engine():
    """Sampled (the tiny config's policy), int8."""
    return tengine.TTSEngine(pconfig.tiny_tts_config(max_tokens=8),
                             quantize="int8", device="cpu")


def _pieces(eng, text):
    return split_for_budget(
        text, lambda s: len(eng.tokenizer.encode(s)),
        piece_token_budget(eng.cfg.max_tokens))


def _by_hand(eng, pieces, seed, max_batch):
    """synthesize_long's pieces computed one call at a time."""
    parts = [eng.synthesize(pieces[0], seed=seed)]
    for g in range(1, len(pieces), max_batch):
        group = pieces[g:g + max_batch]
        if len(group) == 1:
            parts.append(eng.synthesize(group[0], seed=seed + g))
        else:
            parts += eng.synthesize_batch(group, seed=seed + g)
    return parts


def test_stitches_its_pieces_in_order(engine):
    """The first piece alone with seed, then groups of max_batch (3)
    through synthesize_batch(seed + g), the last group, of one, through
    synthesize."""
    max_batch = 3
    pieces = _pieces(engine, TEXT)
    assert len(pieces) == 5
    chunks = []
    res = engine.synthesize_long(TEXT, seed=5, max_batch=max_batch,
                                 on_chunk=chunks.append)
    parts = _by_hand(engine, pieces, 5, max_batch)
    np.testing.assert_array_equal(
        res.codes, np.concatenate([p.codes for p in parts]))
    assert res.n_tokens == len(res.codes) > 0
    assert len(res.audio_int16) == res.n_tokens * 1920
    np.testing.assert_array_equal(np.concatenate(chunks), res.audio_int16)
    plain = engine.synthesize_long(TEXT, seed=5, max_batch=max_batch)
    np.testing.assert_array_equal(
        plain.audio_int16, np.concatenate([p.audio_int16 for p in parts]))
    assert plain.first_audio_seconds is not None


def test_with_and_without_a_consumer(engine):
    chunks = []
    streamed = engine.synthesize_long(TEXT, seed=2, on_chunk=chunks.append)
    plain = engine.synthesize_long(TEXT, seed=2)
    np.testing.assert_array_equal(streamed.codes, plain.codes)
    np.testing.assert_array_equal(np.concatenate(chunks),
                                  streamed.audio_int16)
    assert len(chunks) >= len(_pieces(engine, TEXT))
    delta = np.abs(streamed.audio_int16.astype(np.int32)
                   - plain.audio_int16.astype(np.int32))
    assert delta.max() <= 1 and float((delta > 0).mean()) < 1e-4
    assert streamed.first_audio_seconds is not None


def test_single_piece_passes_through(engine, tmp_path):
    out = tmp_path / "x.wav"
    res_long = engine.synthesize_long("Я", seed=3, output=str(out))
    res = engine.synthesize("Я", seed=3)
    np.testing.assert_array_equal(res_long.codes, res.codes)
    np.testing.assert_array_equal(res_long.audio_int16, res.audio_int16)
    assert out.stat().st_size == 44 + 2 * len(res.audio_int16)


def test_covers_all_text_past_one_request(engine):
    """A direct request of a 19-token text is paced and capped at 8
    tokens; the pieces each decode whole, so the paragraph gets more."""
    res_long = engine.synthesize_long("Одна фраза", seed=3)
    res = engine.synthesize("Одна фраза", seed=3)
    assert res.n_tokens <= engine.cfg.max_tokens < res_long.n_tokens


def test_bad_arguments_raise(engine):
    with pytest.raises(ValueError, match="unsupported language"):
        engine.synthesize_long("Текст. Ещё текст.", language="klingon")
    with pytest.raises(ValueError, match="max_tokens"):
        engine.synthesize_long("Текст. Ещё текст.", max_tokens=0)


def test_greedy_codes_match_jax():
    jp = jweights.init_random_params(JCFG, seed=1, dtype=jnp.float32)
    want = jengine.TTSEngine(JCFG, params=jp, dtype=jnp.float32
                             ).synthesize_long("ab cd ef gh", seed=0)
    eng = tengine.TTSEngine(PCFG, params=tweights.from_jax_numpy(_np(jp)),
                            dtype=torch.float32, device="cpu")
    assert len(_pieces(eng, "ab cd ef gh")) == 4
    got = eng.synthesize_long("ab cd ef gh", seed=0)
    assert got.n_tokens == want.n_tokens > 0
    np.testing.assert_array_equal(got.codes, np.asarray(want.codes))
