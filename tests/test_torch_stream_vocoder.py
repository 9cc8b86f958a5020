"""The port's streaming vocoder (models/vocoder_stream.py) and its chunked
exact vocoder (models/vocoder.synthesize_exact and
synthesize_chunked_context) against the JAX package, on the CPU at tiny
geometry.

Weights are drawn once in JAX and carried to the port through
io/weights.from_jax_numpy. Two tolerances:
- port against JAX: f32 atol 1e-4, the precedent of
  test_vocoder_decode_matches_jax (f32 convolutions in another summation
  order);
- the port's stream against the port's own decode_raw: the stream
  contract of tests/test_vocoder_stream.py, f32 atol 1e-6 and int16
  within +-1 LSB on < 0.01% of samples (the attention over [KV window +
  chunk] keys adds up in another order than the full forward).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qwen3_tts_tpu import config as C
from qwen3_tts_tpu.io import weights as jweights
from qwen3_tts_tpu.models import vocoder as jvoc
from qwen3_tts_tpu.models import vocoder_stream as jvs
from qwen3_tts_tpu_torch import config as pconfig
from qwen3_tts_tpu_torch.io import weights as tweights
from qwen3_tts_tpu_torch.models import vocoder as tvoc
from qwen3_tts_tpu_torch.models import vocoder_stream as tvs

torch.set_num_threads(1)

JCFG = C.tiny_tts_config().vocoder
PCFG = pconfig.tiny_tts_config().vocoder
U = PCFG.total_upsample
CROP = PCFG.output_crop
ATOL_JAX = 1e-4


def assert_stream_equal(got: np.ndarray, want: np.ndarray) -> None:
    """The stream contract: f32 within 1e-6; int16 within +-1 LSB on
    < 0.01% of samples."""
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0.0, atol=1e-6)
    delta = np.abs(tvoc.to_int16(got).astype(np.int32)
                   - tvoc.to_int16(want).astype(np.int32))
    assert delta.max() <= 1, f"int16 delta {delta.max()} > 1 LSB"
    assert float((delta > 0).mean()) < 1e-4


@pytest.fixture(scope="module")
def vp():
    """Tiny f32 vocoder weights: (JAX tree, port tree)."""
    jp = jweights.init_random_params(C.tiny_tts_config(), seed=5,
                                     dtype=jnp.float32)["vocoder"]
    tp = tweights.from_jax_numpy(
        {"vocoder": jax.tree.map(np.asarray, jp)})["vocoder"]
    return jp, tp


def _codes(seed, T):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2048, (T, 16)).astype(np.int32)


def _stream_port(tp, codes, chunks):
    st = tvs.init_stream_state(PCFG, device="cpu")
    parts, at = [], 0
    for ci, c in enumerate(chunks):
        x = torch.from_numpy(codes[None, at:at + c])
        a, st = tvs.stream_step(tp, st, x, PCFG, primed=ci > 0)
        parts.append(a[0].numpy())
        at += c
    return np.concatenate(parts), st


_jax_step = jax.jit(jvs.stream_step, static_argnames=("cfg", "primed"))


def _stream_jax(jp, codes, chunks):
    st = jvs.init_stream_state(JCFG)
    parts, at = [], 0
    for ci, c in enumerate(chunks):
        a, st = _jax_step(jp, st, jnp.asarray(codes[None, at:at + c]),
                          JCFG, primed=ci > 0)
        parts.append(np.asarray(a)[0])
        at += c
    return np.concatenate(parts)


@pytest.mark.parametrize("chunks", [(9,), (5, 1, 8, 6, 3), (6, 5, 4)],
                         ids=["prime-only", "irregular-wraps-window",
                             "zero-flush"])
def test_stream_step_matches_jax(vp, chunks):
    """The same codes and chunk sizes through both streams: a prime of
    one quantum, an irregular stream longer than the sliding window (8
    at tiny geometry) so the rolling KV wraps, and a stream whose last
    chunk is zero codes (the flush)."""
    jp, tp = vp
    T = sum(chunks)
    codes = _codes(10 + T, T)
    if chunks == (6, 5, 4):
        codes[11:] = 0
    got, st = _stream_port(tp, codes, chunks)
    want = _stream_jax(jp, codes, chunks)
    assert got.shape == want.shape == (T * U - CROP,)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_JAX)
    assert st["pos"] == T and isinstance(st["pos"], int)


def test_init_stream_state_matches_jax_shapes():
    want = jax.tree.map(lambda a: tuple(a.shape),
                        jvs.init_stream_state(JCFG, batch=2))
    got = tvs.init_stream_state(PCFG, batch=2, device="cpu")
    pos = got.pop("pos")
    assert pos == 0 and want.pop("pos") == ()
    got = jax.tree.map(lambda t: tuple(t.shape), got)
    assert got == want


def test_stream_matches_own_full_decode(vp):
    """23 frames in irregular chunks (the KV window wraps) against the
    port's decode_raw of all 23."""
    _, tp = vp
    codes = _codes(0, 23)
    got, _ = _stream_port(tp, codes, (5, 1, 8, 6, 3))
    want = tvoc.decode_raw(tp, torch.from_numpy(codes[None]), PCFG)[0]
    assert_stream_equal(got, want.numpy()[:23 * U - CROP])


@pytest.mark.parametrize("live_end", [8, 10, 0],
                         ids=["prime", "prime-rest-waits", "final-only"])
def test_stepper_advance_matches_synthesize_exact(vp, live_end):
    """StreamStepper.advance over a codes row as the engine and the batcher
    drive it: live frames first (whole quanta; at 10 frames the 2 past
    the quantum wait), then the end with a zero-code flush past it (the
    row is shorter than the last quantum, so the step reads zeros past
    it), each segment taken up to the utterance's n tokens. The pieces
    are synthesize_exact's audio within the stream contract, as int16
    (the stepper converts on the device); a finished stream advances no
    further."""
    _, tp = vp
    n = 11
    codes = _codes(2, n)
    stepper = tvs.StreamStepper(PCFG)
    row = torch.from_numpy(codes)
    stream = tvs.Stream()
    segs = stepper.advance(tp, row, stream, live_end, False)
    assert stream.frames == (8 if live_end else 0)
    segs += stepper.advance(tp, row, stream, n, True)
    assert stream.frames >= n + 1
    assert stepper.advance(tp, row, stream, n, True) == []
    got = np.concatenate([s.take(n) for s in segs])
    assert got.dtype == np.int16 and got.shape == (n * U,)
    want = tvoc.synthesize_exact(
        lambda ch: tvoc.decode(tp, ch, PCFG), codes, device="cpu")
    delta = np.abs(got.astype(np.int32)
                   - tvoc.to_int16(want).astype(np.int32))
    assert delta.max() <= 1 and float((delta > 0).mean()) < 1e-4


def test_plan_quanta_matches_jax():
    j, t = jvs.StreamStepper(JCFG), tvs.StreamStepper(PCFG)
    assert t.SIZES == j.SIZES
    for n in (0, 1, 7, 8, 9, 15, 16, 31, 48, 63, 64, 65, 100, 129, 200):
        for overshoot in (False, True):
            assert t.plan_quanta(n, overshoot) == j.plan_quanta(n, overshoot)


_jax_decode = jax.jit(jvoc.decode, static_argnames=("cfg",))


def _decoders(vp):
    jp, tp = vp
    return (lambda ch: _jax_decode(jp, jnp.asarray(ch), cfg=JCFG),
            lambda ch: tvoc.decode(tp, ch, PCFG))


@pytest.mark.parametrize("n", [255, 256, 257])
def test_synthesize_exact_matches_jax_at_bucket_edges(vp, n):
    """One window up to 256 tokens, left-context chunking past it."""
    jdec, tdec = _decoders(vp)
    codes = _codes(n, n)
    want = jvoc.synthesize_exact(jdec, codes)
    got = tvoc.synthesize_exact(tdec, codes, device="cpu")
    assert got.shape == want.shape == (n * U,)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_JAX)


@pytest.mark.parametrize("context", [25, 130])
def test_synthesize_chunked_context_matches_jax(vp, context):
    """130 tokens in chunks of 64 with 25 tokens of left context (the
    default), and with context >= the sequence, which is sample-exact
    against the one-window decode."""
    jdec, tdec = _decoders(vp)
    codes = _codes(7, 130)
    want = jvoc.synthesize_chunked_context(jdec, codes, 64, context)
    got = tvoc.synthesize_chunked_context(tdec, codes, 64, context,
                                          device="cpu")
    assert got.shape == want.shape == (130 * U,)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_JAX)
    if context >= 130:
        one = tvoc.synthesize_exact(tdec, codes, device="cpu")
        np.testing.assert_allclose(got, one, rtol=0, atol=1e-6)


def test_synthesize_exact_truncation_matches_jax():
    """300 codes at the full geometry's sliding window of 72 tokens (tiny
    widths otherwise): synthesize_exact's chunks keep 25 tokens of left
    context, fewer than the window, so they truncate the attention's
    receptive field. The port's synthesize_exact and its one-window
    decode each equal JAX's within 1e-4, and so does its gap to the
    one window, which is real (above f32 rounding) and within the JAX
    package's 1e-4 bound for this truncation
    (tests/test_vocoder_golden.py)."""
    jcfg = dataclasses.replace(JCFG, sliding_window=72)
    pcfg = dataclasses.replace(PCFG, sliding_window=72)
    jp = jweights.init_random_params(C.tiny_tts_config(), seed=6,
                                     dtype=jnp.float32)["vocoder"]
    tp = tweights.from_jax_numpy(
        {"vocoder": jax.tree.map(np.asarray, jp)})["vocoder"]
    jdec = jax.jit(lambda ch: jvoc.decode(jp, ch, jcfg))
    n = 300
    codes = _codes(n, n)
    want = jvoc.synthesize_exact(jdec, codes)
    got = tvoc.synthesize_exact(lambda ch: tvoc.decode(tp, ch, pcfg), codes,
                                device="cpu")
    W = tvoc.voc_bucket(n + 1)
    one_j = np.asarray(jdec(jnp.asarray(tvoc.pad_window(codes, W, "cpu"))))
    one_t = tvoc.decode(tp, tvoc.pad_window(codes, W, "cpu"), pcfg).numpy()
    one_j, one_t = one_j[0, :n * U], one_t[0, :n * U]
    assert got.shape == want.shape == (n * U,)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_JAX)
    np.testing.assert_allclose(one_t, one_j, rtol=0, atol=ATOL_JAX)
    gap_t = float(np.abs(got - one_t).max())
    gap_j = float(np.abs(want - one_j).max())
    assert 1e-6 < gap_t <= 1e-4 and 1e-6 < gap_j <= 1e-4
    assert abs(gap_t - gap_j) <= 0.1 * gap_j


def test_to_int16_device_matches_jax():
    audio = np.array([-1.5, -1.0, -0.3, -1e-5, 0.0, 0.5, 1.0, 2.0],
                     np.float32)
    got = tvoc.to_int16_device(torch.from_numpy(audio)).numpy()
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, np.asarray(
        jvoc.to_int16_device(jnp.asarray(audio))))
    np.testing.assert_array_equal(got, tvoc.to_int16(audio))
