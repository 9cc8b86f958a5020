"""The port's reference-protocol compatibility stack
(qwen3_tts_tpu_torch.serve.compat) and its client and launcher on the
CPU at tiny geometry: the full reference-client flow against the JAX
stack on the same weights (greedy: equal codes), the protocol's
sentinels and bounds, and vocoder.synthesize_chunked against JAX's."""

import dataclasses
import json
import os
import signal
import socket
import struct
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qwen3_tts_tpu import config as C
from qwen3_tts_tpu.io import weights as jweights
from qwen3_tts_tpu.io.tokenizer import ByteFallbackTokenizer as JBytes
from qwen3_tts_tpu.models import vocoder as jvoc
from qwen3_tts_tpu.serve import compat as jcompat
from qwen3_tts_tpu_torch import config as pconfig
from qwen3_tts_tpu_torch.io import weights as tweights
from qwen3_tts_tpu_torch.io.tokenizer import ByteFallbackTokenizer
from qwen3_tts_tpu_torch.models import vocoder as tvoc
from qwen3_tts_tpu_torch.serve import compat
from qwen3_tts_tpu_torch.tools import launch_compat_stack
from qwen3_tts_tpu_torch.tools.reference_client import reference_flow

torch.set_num_threads(1)

GREEDY = C.SamplingConfig(temperature=0.0, repetition_penalty=1.0,
                          cp_temperature=0.0)
JCFG = dataclasses.replace(C.tiny_tts_config(max_tokens=6), sampling=GREEDY)
PCFG = dataclasses.replace(
    pconfig.tiny_tts_config(max_tokens=6),
    sampling=pconfig.SamplingConfig(**dataclasses.asdict(GREEDY)))


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items() if k != "layers_list"}
    return np.asarray(tree)


def _wait(paths):
    deadline = time.time() + 30
    while time.time() < deadline and not all(map(os.path.exists, paths)):
        time.sleep(0.05)
    assert all(map(os.path.exists, paths))


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    """The port's stack and the JAX stack, greedy, f32, same weights."""
    jp = jweights.init_random_params(JCFG, seed=0, dtype=jnp.float32)
    tp = tweights.from_jax_numpy(_np(jp))
    base = tmp_path_factory.mktemp("sock")
    tpaths = tuple(str(base / f"t_{n}.sock") for n in ("talk", "cp", "voc"))
    jpaths = tuple(str(base / f"j_{n}.sock") for n in ("talk", "cp", "voc"))
    tservers, _ = compat.launch_all(tp, PCFG, ByteFallbackTokenizer(),
                                    *tpaths, device="cpu")
    jservers, _ = jcompat.launch_all(jp, JCFG, JBytes(), *jpaths)
    _wait(tpaths + jpaths)
    yield tp, tpaths, jpaths
    for s in tservers + jservers:
        s.stop()


def test_full_reference_flow_greedy_matches_jax(stacks):
    """The reference client's loop (talker -> code predictor per token ->
    host feedback -> talker; then the vocoder) through the port's stack
    and through the JAX stack: equal codes under greedy sampling, in
    range, n_tokens x 1920 samples, int16 within 4 LSB (f32 1e-4 is 3.3
    LSB, plus the rounding)."""
    tp, tpaths, jpaths = stacks
    codes, audio = reference_flow("hello", "russian", tp, *tpaths,
                                  log=lambda m: None)
    jcodes, jaudio = reference_flow("hello", "russian", tp, *jpaths,
                                    log=lambda m: None)
    assert 0 < len(codes) <= PCFG.max_tokens
    assert ((codes >= 0) & (codes < 2048)).all()
    np.testing.assert_array_equal(codes, jcodes)
    assert len(audio) == len(jaudio) == len(codes) * 1920
    assert np.abs(audio.astype(np.int32) - jaudio).max() <= 4


def _recv(c, n):
    data = b""
    while len(data) < n:
        chunk = c.recv(n - len(data))
        if not chunk:
            return None
        data += chunk
    return data


def test_talker_oversized_header_is_error_sentinel(stacks):
    _, (talker, _, _), _ = stacks
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    c.connect(talker)
    c.sendall(struct.pack("<I", compat.MAX_TALKER_REQUEST + 1))
    assert struct.unpack("<i", _recv(c, 4))[0] == compat.SENTINEL_ERROR
    c.close()


@pytest.mark.parametrize("n", [-5, 0, compat.MAX_VOCODER_TOKENS + 1])
def test_vocoder_refuses_bad_counts(stacks, n):
    """The vocoder closes the connection without a reply."""
    _, (_, _, voc_sock), _ = stacks
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    c.connect(voc_sock)
    c.sendall(struct.pack("<i", n))
    c.settimeout(10.0)
    assert c.recv(4) == b""
    c.close()


def test_talker_truncates_overlong_text(stacks):
    """A text past the KV allocation is truncated, not an error: a first
    (code, hidden); the server survives a client that then hangs up."""
    tp, (talker, _, _), _ = stacks
    H = PCFG.talker.hidden_size
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    c.connect(talker)
    msg = json.dumps({"text": "x" * 300, "language": "russian"}).encode()
    c.sendall(struct.pack("<I", len(msg)) + msg)
    code0 = struct.unpack("<i", _recv(c, 4))[0]
    assert code0 != compat.SENTINEL_ERROR
    if code0 >= 0:
        assert _recv(c, H * 4) is not None
        c.sendall(np.zeros(H, np.float32).tobytes())
    c.close()
    codes, _ = reference_flow("after", "russian", tp, *stacks[1],
                              log=lambda m: None)
    assert len(codes) > 0


def _np_decode(codes: np.ndarray) -> np.ndarray:
    """A deterministic stand-in decoder on the host: (1, W, 16) -> (1,
    W * 1920) f32, every sample a function of its token's codes."""
    t = codes[0].astype(np.float32)
    base = np.sin(t.sum(-1) * 0.01)[:, None]
    ramp = np.linspace(-1.0, 1.0, 1920, dtype=np.float32)[None, :]
    return (base * ramp).reshape(1, -1).astype(np.float32)


@pytest.mark.parametrize("n", [40, 64, 100, 130])
def test_synthesize_chunked_matches_jax(n):
    """The crossfade over the same decode function: one window (40, 64),
    a short last window appended raw (100: 100 - 96 < 16), and a blended
    one (130); equal to JAX's bit for bit."""
    codes = np.random.default_rng(n).integers(0, 2048, (n, 16)).astype(
        np.int32)
    want = jvoc.synthesize_chunked(_np_decode, codes)
    got = tvoc.synthesize_chunked(
        lambda t: torch.from_numpy(_np_decode(t.numpy())), codes,
        device="cpu")
    assert got.dtype == np.float32 and len(got) == len(want)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_launch_compat_stack_single_shot(tmp_path, monkeypatch):
    """The launcher with its environment variables: three sockets under
    tmp_path, one synthesis through them, a WAV, exit 0."""
    for var, name in (("TALKER_SOCKET", "t"), ("CP_SOCKET", "c"),
                      ("VOC_SOCKET", "v")):
        monkeypatch.setenv(var, str(tmp_path / f"{name}.sock"))
    monkeypatch.setenv("MAX_TOKENS", "4")
    saved = {s: signal.getsignal(s) for s in (signal.SIGINT,
                                              signal.SIGTERM)}
    try:
        rc = launch_compat_stack.main(
            ["--tiny", "--device", "cpu", "--dtype", "float32",
             "--output", str(tmp_path / "o.wav"), "hello"])
    finally:
        for s, h in saved.items():
            signal.signal(s, h)
    assert rc == 0
    size = (tmp_path / "o.wav").stat().st_size
    assert 44 < size <= 44 + 2 * 4 * 1920
