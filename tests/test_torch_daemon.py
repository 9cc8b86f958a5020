"""The port's socket daemon (qwen3_tts_tpu_torch.serve.daemon) on the CPU
at tiny geometry: the wire format against the JAX daemon's bytes, engine
mode on both accept loops against the port engine's own synthesis,
batched mode at pipeline_depth=2 against a depth-1 batcher, voices by
name, malformed requests, greedy synthesis against the JAX daemon, and
``main`` in a subprocess."""

import dataclasses
import json
import os
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qwen3_tts_tpu import config as C
from qwen3_tts_tpu.engine import engine as jengine
from qwen3_tts_tpu.io import weights as jweights
from qwen3_tts_tpu.serve import daemon as jdaemon
from qwen3_tts_tpu.serve import voices as jvoices
from qwen3_tts_tpu_torch import config as pconfig
from qwen3_tts_tpu_torch.engine.engine import TTSEngine
from qwen3_tts_tpu_torch.io import weights as tweights
from qwen3_tts_tpu_torch.runtime import native
from qwen3_tts_tpu_torch.serve import daemon as tdaemon
from qwen3_tts_tpu_torch.serve.batching import ContinuousBatcher
from qwen3_tts_tpu_torch.serve.voices import VoiceRegistry

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TINY = pconfig.tiny_tts_config(max_tokens=8)


@pytest.fixture(scope="module")
def engine():
    return TTSEngine(TINY, dtype=torch.float32, device="cpu", seed=0)


def _serve(daemon, **kw):
    t = threading.Thread(target=daemon.serve, kwargs=kw, daemon=True)
    t.start()
    deadline = time.time() + 30
    while not os.path.exists(daemon.socket_path) and time.time() < deadline:
        time.sleep(0.02)
    assert os.path.exists(daemon.socket_path), "socket never appeared"
    return t


def _stop(daemon, t):
    daemon.stop()
    t.join(timeout=30)
    assert not t.is_alive()


def _mk_prompt(root: Path, name: str, seed: int) -> str:
    d = root / name
    d.mkdir()
    rng = np.random.default_rng(seed)
    np.save(d / "ref_codec_tokens.npy",
            rng.integers(0, 2048, (6, 16)).astype(np.int64))
    (d / "ref_text.txt").write_text("ref words")
    return str(d)


def test_framing_bytes_match_jax():
    """encode_response gives the JAX daemon's bytes (header with and
    without audio), and decode_response reads either."""
    audio = (np.arange(-50, 50) * 300).astype(np.int16)
    for hdr, a in (({"n_samples": 100, "n_tokens": 1, "rtf": 0.5,
                     "total_seconds": 0.25}, audio),
                   ({"error": "boom", "code": "overloaded"}, None),
                   ({"chunk": 3, "n_samples": 0}, audio[:0])):
        got = tdaemon.encode_response(hdr, a)
        assert got == jdaemon.encode_response(hdr, a)
        h, body = tdaemon.decode_response(got)
        assert h == hdr
        np.testing.assert_array_equal(body, a if a is not None
                                      else np.zeros(0, np.int16))


@pytest.mark.parametrize("native_loop", [False, True])
def test_engine_daemon_blob_and_stream(engine, tmp_path, native_loop):
    """Engine mode on the Python and the native accept loop: the blob's
    audio is the engine's synthesize(seed) bit for bit, the stream's
    frames arrive before its done-frame and concatenate to the engine's
    streamed audio, a bad language is an error header and the daemon
    serves on."""
    if native_loop:
        assert native.available()
    daemon = tdaemon.TTSDaemon(engine, str(tmp_path / "d.sock"))
    t = _serve(daemon, native_loop=native_loop)
    try:
        client = tdaemon.DaemonClient(daemon.socket_path)
        hdr, audio = client.synthesize("hello", language="english", seed=1)
        want = engine.synthesize("hello", language="english", seed=1)
        assert hdr["n_tokens"] == want.n_tokens > 0
        assert hdr["n_samples"] == len(audio) == want.n_tokens * 1920
        np.testing.assert_array_equal(audio, want.audio_int16)
        frames = []
        shdr, saudio = client.synthesize(
            "hello", language="english", seed=1, stream=True,
            on_chunk=lambda h, a: frames.append((h, len(a))))
        assert shdr["done"] is True and shdr["n_tokens"] == want.n_tokens
        assert [h.get("chunk") for h, _ in frames[:-1]] == list(
            range(len(frames) - 1))
        assert sum(n for _, n in frames) == len(saudio) == len(audio)
        # the stream is the engine's own stream, and within the stream
        # contract (+-1 LSB) of the blob
        want_s = engine.synthesize("hello", language="english", seed=1,
                                   streaming=True, on_chunk=lambda a: None)
        np.testing.assert_array_equal(saudio, want_s.audio_int16)
        assert np.abs(saudio.astype(np.int32) - audio).max() <= 1
        with pytest.raises(RuntimeError, match="unsupported language"):
            client.synthesize("x", language="klingon")
        snap = client.stats()
        assert snap["mode"] == "engine"
        assert snap["requests"] == 2 and snap["errors"] == 1
    finally:
        _stop(daemon, t)


def test_engine_daemon_long_and_max_tokens(engine, tmp_path):
    """A "long" request is the engine's synthesize_long, and max_tokens
    caps a request."""
    daemon = tdaemon.TTSDaemon(engine, str(tmp_path / "d.sock"))
    t = _serve(daemon, native_loop=False)
    try:
        client = tdaemon.DaemonClient(daemon.socket_path)
        text = "One two. Three four five. Six."
        hdr, audio = client.synthesize(text, seed=2, long=True)
        want = engine.synthesize_long(text, seed=2)
        assert hdr["n_tokens"] == want.n_tokens
        np.testing.assert_array_equal(audio, want.audio_int16)
        hdr, audio = client.synthesize("cap me please", seed=0,
                                       max_tokens=2)
        assert hdr["n_tokens"] <= 2 and len(audio) == hdr["n_tokens"] * 1920
    finally:
        _stop(daemon, t)


def _batched(engine, tmp_path, voices=None):
    """A batched daemon at pipeline_depth=2 over two slots."""
    b = ContinuousBatcher(engine.cfg, engine.params, batch_size=2,
                          decode_chunk=4, dtype=torch.float32, device="cpu",
                          pipeline_depth=2)
    return tdaemon.TTSDaemon(engine, str(tmp_path / "b.sock"), batcher=b,
                             voices=voices)


def _depth1(engine, text, seed, prompt_dir=None, stream=False):
    """The request's (codes, audio) through a depth-1 batcher."""
    b = ContinuousBatcher(engine.cfg, engine.params, batch_size=2,
                          decode_chunk=4, dtype=torch.float32, device="cpu")
    d = tdaemon.TTSDaemon(engine, "unused", batcher=b)
    ids, n, ref, n_target = d._encode_with_prompt(text, prompt_dir)
    f = b.submit(ids, n, seed=seed, ref_codes=ref, n_target=n_target,
                 on_chunk=(lambda seg: None) if stream else None)
    while not f.done():
        b.step()
    return f.result()


def test_batched_daemon_concurrent_at_depth2(engine, tmp_path):
    """Four concurrent clients, one streaming, through two slots at
    pipeline_depth=2: each response is the audio a depth-1 batcher gives
    for the same seed, the stream's frames make up its audio, and the
    stats report the batcher."""
    daemon = _batched(engine, tmp_path)
    t = _serve(daemon)
    results = {}
    try:
        client = tdaemon.DaemonClient(daemon.socket_path)

        def call(i):
            results[i] = client.synthesize(f"req {i}", language="english",
                                           seed=i, stream=(i == 1))

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        snap = client.stats()
    finally:
        _stop(daemon, t)
    assert sorted(results) == [0, 1, 2, 3]
    for i, (hdr, audio) in results.items():
        codes, want = _depth1(engine, f"req {i}", i, stream=(i == 1))
        assert hdr["n_tokens"] == len(codes)
        np.testing.assert_array_equal(audio, want)
    assert results[1][0]["done"] is True
    assert snap["mode"] == "batched" and snap["requests"] == 4
    assert snap["batcher"]["batch_size"] == 2


def test_batched_voice_by_name_and_errors(engine, tmp_path):
    """The registry scans its root as the JAX one does; a request by
    voice name is the request by its prompt dir (the depth-1 cloned
    audio); an unknown name lists the voices; voice and prompt_dir
    together are refused."""
    root = tmp_path / "voices"
    root.mkdir()
    alice = _mk_prompt(root, "alice", 7)
    (root / "not_a_voice").mkdir()
    reg = VoiceRegistry(str(root))
    assert reg.names() == jvoices.VoiceRegistry(str(root)).names() == [
        "alice"]
    with pytest.raises(ValueError, match="invalid voice name"):
        reg.register("default", alice)
    daemon = _batched(engine, tmp_path, voices=reg)
    t = _serve(daemon)
    try:
        client = tdaemon.DaemonClient(daemon.socket_path)
        hdr, audio = client.synthesize("hi", seed=4, voice="alice")
        _, want = _depth1(engine, "hi", 4, prompt_dir=alice)
        np.testing.assert_array_equal(audio, want)
        with pytest.raises(RuntimeError, match=r"unknown voice 'bob'.*alice"):
            client.synthesize("hi", voice="bob")
        with pytest.raises(RuntimeError, match="not both"):
            client.synthesize("hi", voice="alice", prompt_dir=alice)
        with pytest.raises(RuntimeError, match="prompt_dir"):
            client.synthesize("hi", prompt_dir=str(tmp_path / "missing"))
    finally:
        _stop(daemon, t)


def _raw(path, payload: bytes, length=None) -> dict:
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    c.connect(path)
    try:
        n = len(payload) if length is None else length
        c.sendall(struct.pack("<I", n) + payload)
        c.settimeout(60)
        frame = tdaemon._recv_exact(c, struct.unpack(
            "<I", tdaemon._recv_exact(c, 4))[0])
        return tdaemon.decode_response(frame)[0]
    finally:
        c.close()


def test_batched_daemon_survives_malformed_requests(engine, tmp_path):
    """Non-JSON, empty text, an unsupported language, max_tokens 0 and a
    declared length past MAX_REQUEST_BYTES each get an error header (the
    stream form a done-frame); the daemon then serves a request."""
    daemon = _batched(engine, tmp_path)
    t = _serve(daemon)
    path = daemon.socket_path
    try:
        assert "error" in _raw(path, b"\xff not json")
        assert _raw(path, b'{"text": ""}')["error"] == "empty text"
        assert "unsupported language" in _raw(path, json.dumps(
            {"text": "x", "language": "klingon"}).encode())["error"]
        h = _raw(path, json.dumps({"text": "x", "max_tokens": 0,
                                   "stream": True}).encode())
        assert h["done"] is True and "max_tokens" in h["error"]
        h = _raw(path, b"", length=tdaemon.MAX_REQUEST_BYTES + 1)
        assert h["code"] == "too_large"
        hdr, audio = tdaemon.DaemonClient(path).synthesize("ok", seed=0)
        assert len(audio) == hdr["n_tokens"] * 1920 > 0
    finally:
        _stop(daemon, t)
    assert daemon.stats.snapshot()["errors"] == 4


def test_greedy_daemon_matches_jax(tmp_path):
    """f32 greedy engine-mode daemons of both packages on the same
    weights: equal n_tokens, int16 audio within 4 LSB (the f32 1e-4 of
    tests/test_torch_slice.py is 3.3 LSB, plus the rounding)."""
    greedy = C.SamplingConfig(temperature=0.0, repetition_penalty=1.0,
                              cp_temperature=0.0)
    jcfg = dataclasses.replace(C.tiny_tts_config(max_tokens=8),
                               sampling=greedy)
    pcfg = dataclasses.replace(
        TINY, sampling=pconfig.SamplingConfig(**dataclasses.asdict(greedy)))
    jp = jweights.init_random_params(jcfg, seed=1, dtype=jnp.float32)
    tp = tweights.from_jax_numpy(_np(jp))
    jd = jdaemon.TTSDaemon(jengine.TTSEngine(jcfg, params=jp,
                                             dtype=jnp.float32),
                           str(tmp_path / "j.sock"))
    td = tdaemon.TTSDaemon(TTSEngine(pcfg, params=tp, dtype=torch.float32,
                                     device="cpu"),
                           str(tmp_path / "t.sock"))
    req = json.dumps({"text": "Привет, мир!", "seed": 0}).encode()
    jh, ja = jdaemon.decode_response(jd.handle(req))
    th, ta = tdaemon.decode_response(td.handle(req))
    assert "error" not in th and th["n_tokens"] == jh["n_tokens"] > 0
    assert len(ta) == len(ja)
    assert np.abs(ta.astype(np.int32) - ja.astype(np.int32)).max() <= 4


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items() if k != "layers_list"}
    return np.asarray(tree)


def test_main_batched_warmup_and_sigterm(tmp_path):
    """``python -m qwen3_tts_tpu_torch.serve.daemon --tiny --device cpu
    --batch 2``: it warms up through the batcher, binds, serves a
    request at pipeline_depth=2 (the default), and on SIGTERM drains and
    exits 0 with its socket removed."""
    sock = str(tmp_path / "main.sock")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "qwen3_tts_tpu_torch.serve.daemon", "--tiny",
         "--device", "cpu", "--dtype", "float32", "--batch", "2",
         "--decode_chunk", "4", "--python_loop", "--socket", sock],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        deadline = time.time() + 240
        while not os.path.exists(sock):
            assert proc.poll() is None, proc.stdout.read().decode(
                errors="replace")
            assert time.time() < deadline, "the socket never appeared"
            time.sleep(0.1)
        hdr, audio = tdaemon.DaemonClient(sock).synthesize(
            "batched signal", language="english", seed=2)
        assert hdr["n_tokens"] > 0 and len(audio) == hdr["n_tokens"] * 1920
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
        out = out.decode(errors="replace")
        assert proc.returncode == 0, out
        assert "shutting down" in out
        assert not os.path.exists(sock)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
