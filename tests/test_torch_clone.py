"""Voice cloning in the port, on the CPU at tiny geometry, against the
JAX package (f32, greedy, the same weights):

- clone_frame_embeds and build_prefix_cloned equal JAX's bit for bit;
  cloned_ref_limit and bucket_ref_frames equal JAX's on a grid;
- ``synthesize(prompt_dir=...)`` gives the JAX engine's greedy codes,
  streamed too, and a second request is a prefix-cache hit;
- a transcript that overflows the prefix and a bad prompt dir raise
  ValueError;
- the batcher's cloned request, dense and paged, beside a plain one,
  gives the engine's cloned codes from the same prefix tensor (JAX's
  tests/test_voice_clone.py::test_batched_prompt_matches_engine).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qwen3_tts_tpu import config as C
from qwen3_tts_tpu.engine import engine as jengine
from qwen3_tts_tpu.io import weights as jweights
from qwen3_tts_tpu.models import talker as jtk
from qwen3_tts_tpu_torch import config as pconfig
from qwen3_tts_tpu_torch.engine import engine as tengine
from qwen3_tts_tpu_torch.io import weights as tweights
from qwen3_tts_tpu_torch.models import talker as ttk
from qwen3_tts_tpu_torch.serve import batching as tbatching

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


def _ref_codes(n, seed):
    return np.random.default_rng(seed).integers(0, 2048, (n, 16)).astype(
        np.int32)


def _prompt(path, n_frames, text, seed=9):
    path.mkdir()
    # int64 on disk, as the encoder tool writes them
    np.save(path / "ref_codec_tokens.npy",
            _ref_codes(n_frames, seed).astype(np.int64))
    (path / "ref_text.txt").write_text(text)
    return str(path)


@pytest.fixture(scope="module")
def weights():
    jp = jweights.init_random_params(JCFG, seed=1, dtype=jnp.float32)
    return jp, tweights.from_jax_numpy(_np(jp))


@pytest.fixture(scope="module")
def port(weights):
    return tengine.TTSEngine(PCFG, params=weights[1], dtype=torch.float32,
                             device="cpu")


@pytest.mark.parametrize("n_ref", [0, 7, 16])
def test_cloned_prefix_matches_jax(weights, n_ref):
    """Against JAX within f32 atol 1e-6, the bound of
    tests/test_torch_modules.py's build_prefix test (the text projection
    MLP, which gives tts_pad_embed, adds up in another order); and bit
    for bit, the layout: the plain prefix, then the first n_ref frames,
    then zeros."""
    jp, tp = weights
    ids = np.array([10, 20, 30, 40, 50, 60, 0, 0], np.int32)
    codes = _ref_codes(16, 3)
    jt, tt = jp["talker"], tp["talker"]
    jcp, tcp = jp["code_predictor"]["codec_embs"], \
        tp["code_predictor"]["codec_embs"]
    frames = ttk.clone_frame_embeds(tt, tcp, torch.from_numpy(codes))
    np.testing.assert_allclose(
        frames.numpy(),
        np.asarray(jtk.clone_frame_embeds(jt, jcp, jnp.asarray(codes))),
        rtol=0, atol=1e-6)
    want, wlen = jtk.build_prefix_cloned(jt, jcp, jnp.asarray(ids),
                                         jnp.int32(6), jnp.asarray(codes),
                                         jnp.int32(n_ref))
    got, glen = ttk.build_prefix_cloned(tt, tcp, torch.from_numpy(ids), 6,
                                        torch.from_numpy(codes), n_ref)
    assert got.shape == want.shape == (8 + ttk.PREFIX_EXTRA + 16, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    plen = 6 + ttk.PREFIX_EXTRA
    assert int(glen) == int(wlen) == plen + n_ref
    plain, _ = ttk.build_prefix(tt, torch.from_numpy(ids), 6)
    assert torch.equal(got[:plen], plain[:plen])
    assert torch.equal(got[plen:plen + n_ref], frames[:n_ref])
    assert not got[plen + n_ref:].any()
    assert not np.asarray(want[plen + n_ref:]).any()


def test_ref_limit_and_bucket_match_jax():
    for cap in (0, 20, 128, 512, 1024):
        for text_pad in (16, 64, 256):
            assert ttk.cloned_ref_limit(cap, text_pad) == \
                jtk.cloned_ref_limit(cap, text_pad)
    for n in (0, 1, 15, 16, 17, 40, 100, 256, 257, 300, 700):
        codes = _ref_codes(n, n)
        for limit in (0, 1, 10, 16, 50, 64, 95, 200, 256, 300, 1000):
            gp, gn = ttk.bucket_ref_frames(limit, codes)
            wp, wn = jtk.bucket_ref_frames(limit, codes)
            assert gn == wn
            np.testing.assert_array_equal(gp, wp)
            assert gp.dtype == np.int32


@pytest.fixture(scope="module")
def jax_engine(weights):
    return jengine.TTSEngine(JCFG, params=weights[0], dtype=jnp.float32)


# a one-token target paces EOS to at most 7 tokens (forced past 2x the
# expected 3 a text token), which pacing on the transcript's count would
# not
@pytest.mark.parametrize("target", ["hello", "a"])
def test_prompt_dir_matches_jax(jax_engine, port, tmp_path, monkeypatch,
                                target):
    d = _prompt(tmp_path / "voice", 40, "ref words")
    want = jax_engine.synthesize(target, language="english", seed=0,
                                 prompt_dir=d)
    port._prefix_cache.clear()
    got = port.synthesize(target, language="english", seed=0,
                          prompt_dir=d)
    assert got.n_tokens == want.n_tokens > 0
    if target == "a":
        assert got.n_tokens < PCFG.max_tokens
    np.testing.assert_array_equal(got.codes, np.asarray(want.codes))
    assert len(got.audio_int16) == got.n_tokens * 1920
    # the second request is a hit: no prefill
    monkeypatch.setattr(port, "_prefill_state", None)
    pieces = []
    streamed = port.synthesize(target, language="english", seed=0,
                               prompt_dir=d, streaming=True,
                               on_chunk=pieces.append)
    np.testing.assert_array_equal(streamed.codes, got.codes)
    np.testing.assert_array_equal(np.concatenate(pieces),
                                  streamed.audio_int16)
    delta = np.abs(streamed.audio_int16.astype(np.int32)
                   - got.audio_int16.astype(np.int32))
    assert delta.max() <= 1
    assert len(port._prefix_cache) == 1


def test_overflow_and_bad_prompt_dir_raise(port, tmp_path):
    d = _prompt(tmp_path / "long_ref", 6, "r" * 100)
    with pytest.raises(ValueError, match="overflows the prefix"):
        port.synthesize("target words here", prompt_dir=d)
    with pytest.raises(ValueError, match="too long for voice cloning"):
        port.synthesize_long("target words here", prompt_dir=d)
    with pytest.raises(ValueError, match="invalid prompt_dir"):
        port.synthesize("a", prompt_dir=str(tmp_path / "missing"))
    flat = tmp_path / "flat"
    flat.mkdir()
    np.save(flat / "ref_codec_tokens.npy", np.arange(16))
    with pytest.raises(ValueError, match="invalid prompt_dir"):
        port.synthesize("a", prompt_dir=str(flat))


@pytest.mark.parametrize("target", ["clone batched", "a"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_batched_prompt_matches_engine(weights, port, tmp_path, paged,
                                       target):
    """A cloned request through the batcher (float code predictor, as
    the engine's) beside a plain one gives the engine's codes (paced on
    the target's tokens), from the engine's prefix."""
    d = _prompt(tmp_path / "voice", 7, "ref words here")
    want = port.synthesize(target, seed=4, prompt_dir=d)
    assert want.n_tokens > 0
    ref_codes, ref_text = port._load_prompt(d)
    ids, n_text, n_target = port._encode_cloned(target, ref_text)
    b = tbatching.ContinuousBatcher(PCFG, weights[1], batch_size=2,
                                    decode_chunk=4, dtype=torch.float32,
                                    paged=paged, page_size=16,
                                    quantize_cp=False, device="cpu")
    plain_ids, plain_n = port._encode_text("plain neighbor")
    f_o = b.submit(plain_ids, plain_n, seed=1)
    f = b.submit(ids, n_text, seed=4, ref_codes=ref_codes,
                 n_target=n_target)
    for _ in range(400):
        if f.done() and f_o.done():
            break
        b.step()
    codes, audio = f.result(timeout=1)
    np.testing.assert_array_equal(codes, want.codes)
    assert len(audio) == len(codes) * 1920
    assert len(f_o.result(timeout=1)[0]) > 0
    # the engine cached this request under the batcher's bucketed frames,
    # and both sides' weights and ids give one prefix
    req = f.request
    padded, n_ref = req.cloned_prep
    assert (tuple(ids.tolist()), n_text, n_target, padded.tobytes(),
            n_ref) in port._prefix_cache
    got_prefix, got_len = ttk.request_prefix(
        b._tp, b._cpp["codec_embs"], req.text_ids, req.n_text,
        req.cloned_prep)
    eng_prefix, eng_len = ttk.request_prefix(
        port._tp, port._cpp["codec_embs"], ids, n_text, req.cloned_prep)
    assert torch.equal(got_prefix, eng_prefix)
    assert int(got_len) == int(eng_len) == n_text + ttk.PREFIX_EXTRA + n_ref
