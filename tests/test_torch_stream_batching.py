"""Streaming requests (``submit(on_chunk=...)``) in the port's continuous
batcher, dense and paged, on the CPU at tiny geometry (int8 code
predictor through K2's plain version, sampled draws).

A streaming request's segments concatenate to the audio its Future
resolves to, and that equals the same request's non-streaming audio
from the same batcher (equal codes: the codes depend on the seed only)
within the stream contract of tests/test_vocoder_stream.py: int16
within +-1 LSB on < 0.01% of samples. Streaming and plain requests share
one batch.
"""

import numpy as np
import pytest
import torch

from qwen3_tts_tpu_torch import config as pconfig
from qwen3_tts_tpu_torch.io import weights as tweights
from qwen3_tts_tpu_torch.serve import batching as tbatching

torch.set_num_threads(1)

CFG = pconfig.tiny_tts_config(max_tokens=80)
TEXTS = ["Hello from the port, twice over.", "abc", "Hi there", "Привет"]


@pytest.fixture(scope="module")
def params():
    return tweights.init_random_params(CFG, seed=0, dtype=torch.float32)


def _ids(text, n=32):
    raw = list(text.encode("utf-8"))[:n]
    arr = np.zeros(n, np.int32)
    arr[:len(raw)] = raw
    return arr, len(raw)


def _drain(b, futs, limit=400):
    for _ in range(limit):
        if all(f.done() for f in futs):
            break
        b.step()
    return [f.result(timeout=1) for f in futs]


def _within_stream_contract(got, want):
    assert got.shape == want.shape
    delta = np.abs(got.astype(np.int32) - want.astype(np.int32))
    if len(delta):
        assert delta.max() <= 1 and float((delta > 0).mean()) < 1e-4


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_streaming_requests_share_a_batch_with_plain_ones(params, paged):
    """Four requests through 3 slots, two of them streaming (one long
    enough for several segments, one that finishes inside the head), the
    others plain; then the same four all plain. Each streaming request's
    segments make up its audio, its codes equal its plain run's, and its
    audio is the plain audio within the stream contract."""
    kw = dict(paged=True, page_size=16) if paged else {}
    b = tbatching.ContinuousBatcher(CFG, params, batch_size=3,
                                    decode_chunk=8, dtype=torch.float32,
                                    device="cpu", **kw)
    streamed = {0: [], 1: []}
    futs = [b.submit(*_ids(t), seed=i,
                     on_chunk=(streamed[i].append if i in streamed
                               else None))
            for i, t in enumerate(TEXTS)]
    got = _drain(b, futs)
    want = _drain(b, [b.submit(*_ids(t), seed=i)
                      for i, t in enumerate(TEXTS)])
    for i, ((codes, audio), (wcodes, waudio)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(codes, wcodes)
        assert audio.dtype == np.int16 and len(audio) == len(codes) * 1920
        if i in streamed:
            np.testing.assert_array_equal(np.concatenate(streamed[i]), audio)
            _within_stream_contract(audio, waudio)
        else:
            np.testing.assert_array_equal(audio, waudio)
    assert len(got[0][0]) > b.stream_head_tokens + b.stream_emit_tokens
    assert len(streamed[0]) >= 3     # the head, a paced one, the flush
    assert all(r is None for r in b._slot_req)
    if paged:
        assert len(b._free_pages) == b.pool_pages - 1


def test_failed_segment_fails_the_request(params):
    """A consumer that raises stops the request's segments, and its
    Future raises that error; the request beside it is served."""
    b = tbatching.ContinuousBatcher(CFG, params, batch_size=2,
                                    decode_chunk=8, dtype=torch.float32,
                                    device="cpu")
    calls = []

    def broken(seg):
        calls.append(len(seg))
        raise OSError("client went away")
    f_bad = b.submit(*_ids(TEXTS[2]), seed=2, on_chunk=broken)
    f_ok = b.submit(*_ids(TEXTS[1]), seed=1)
    for _ in range(400):
        if f_bad.done() and f_ok.done():
            break
        b.step()
    with pytest.raises(OSError, match="client went away"):
        f_bad.result(timeout=0)
    assert len(calls) == 1
    codes, audio = f_ok.result(timeout=0)
    assert len(audio) == len(codes) * 1920


def test_streaming_in_the_scheduler_thread(params):
    """The background scheduler thread runs the stream steps (under its
    own inference mode) and calls on_chunk."""
    import threading
    b = tbatching.ContinuousBatcher(CFG, params, batch_size=2,
                                    decode_chunk=8, dtype=torch.float32,
                                    device="cpu")
    threads, pieces = set(), []

    def on_chunk(seg):
        threads.add(threading.get_ident())
        pieces.append(seg)
    b.start()
    try:
        codes, audio = b.submit(*_ids(TEXTS[2]), seed=2,
                                on_chunk=on_chunk).result(timeout=120)
    finally:
        b.stop()
    assert threads and threading.get_ident() not in threads
    np.testing.assert_array_equal(np.concatenate(pieces), audio)
    assert len(audio) == len(codes) * 1920 > 0
