"""The port's HTTP gateway (qwen3_tts_tpu_torch.serve.http) over the
port's daemon on the CPU at tiny geometry: the routes, the audio against
the port engine's own synthesis, the error codes (400, 404, 413, 503),
and prometheus_text against the JAX gateway's for the same snapshot."""

import http.client
import io
import json
import wave

import numpy as np
import pytest
import torch

from qwen3_tts_tpu.serve import http as jhttp
from qwen3_tts_tpu_torch import config as pconfig
from qwen3_tts_tpu_torch.engine.engine import TTSEngine
from qwen3_tts_tpu_torch.serve import http as thttp
from qwen3_tts_tpu_torch.serve.batching import ContinuousBatcher
from qwen3_tts_tpu_torch.serve.daemon import TTSDaemon
from qwen3_tts_tpu_torch.serve.voices import VoiceRegistry

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def gateway(tmp_path_factory):
    root = tmp_path_factory.mktemp("voices")
    d = root / "alice"
    d.mkdir()
    np.save(d / "ref_codec_tokens.npy", np.random.default_rng(3).integers(
        0, 2048, (6, 16)).astype(np.int64))
    engine = TTSEngine(pconfig.tiny_tts_config(max_tokens=8),
                       dtype=torch.float32, device="cpu", seed=0)
    daemon = TTSDaemon(engine, socket_path="unused",
                       voices=VoiceRegistry(str(root)))
    srv = thttp.serve_http(daemon, host="127.0.0.1", port=0)
    yield engine, srv.server_address, str(d)
    srv.shutdown()


def _req(addr, method, path, body=None):
    c = http.client.HTTPConnection(*addr, timeout=300)
    try:
        c.request(method, path,
                  body=json.dumps(body).encode() if isinstance(
                      body, dict) else body)
        r = c.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        c.close()


def _wav(data: bytes) -> np.ndarray:
    with wave.open(io.BytesIO(data), "r") as wf:
        assert wf.getframerate() == pconfig.SAMPLE_RATE
        assert wf.getnchannels() == 1
        return np.frombuffer(wf.readframes(wf.getnframes()), np.int16)


def test_get_routes(gateway):
    _, addr, _ = gateway
    status, _, body = _req(addr, "GET", "/health")
    assert status == 200 and json.loads(body) == {"ok": True}
    status, _, body = _req(addr, "GET", "/v1/stats")
    assert status == 200 and json.loads(body)["mode"] == "engine"
    status, _, body = _req(addr, "GET", "/v1/models")
    assert status == 200 and json.loads(body)["data"][0]["id"] == "qwen3-tts"
    status, _, body = _req(addr, "GET", "/v1/audio/voices")
    assert status == 200
    assert [v["name"] for v in json.loads(body)["data"]] == [
        "default", "alice"]
    for method in ("GET", "POST"):
        status, _, body = _req(addr, method, "/nope", {})
        assert status == 404 and "no route" in json.loads(body)["error"]


def test_synthesize_wav_and_frame_stream(gateway):
    """POST /v1/synthesize: a WAV of the engine's audio with its token
    count in X-Ttsrt-n-tokens; with "stream" the daemon's frames, read by
    HTTPFrameReader, make up the engine's streamed audio."""
    engine, addr, _ = gateway
    req = {"text": "hello http", "language": "english", "seed": 3}
    want = engine.synthesize("hello http", language="english", seed=3)
    status, headers, body = _req(addr, "POST", "/v1/synthesize", req)
    assert status == 200 and headers["Content-Type"] == "audio/wav"
    assert int(headers["X-Ttsrt-n-tokens"]) == want.n_tokens
    np.testing.assert_array_equal(_wav(body), want.audio_int16)

    c = http.client.HTTPConnection(*addr, timeout=300)
    c.request("POST", "/v1/synthesize",
              body=json.dumps(dict(req, stream=True)).encode())
    r = c.getresponse()
    assert r.getheader("Content-Type") == "application/x-ttsrt-frames"
    frames = list(thttp.HTTPFrameReader(r))
    c.close()
    assert frames[-1][0]["done"] is True
    streamed = engine.synthesize("hello http", language="english", seed=3,
                                 streaming=True, on_chunk=lambda a: None)
    np.testing.assert_array_equal(
        np.concatenate([a for _, a in frames]), streamed.audio_int16)


def test_openai_speech(gateway):
    """POST /v1/audio/speech: wav and pcm of the engine's audio; a stream
    of pcm, the engine's streamed audio; a voice by registry name equal to
    the same voice by prompt_dir path."""
    engine, addr, alice = gateway
    want = engine.synthesize("speech", language="english", seed=5)
    base = {"input": "speech", "language": "english", "seed": 5}
    status, headers, body = _req(addr, "POST", "/v1/audio/speech", base)
    assert status == 200 and headers["Content-Type"] == "audio/wav"
    np.testing.assert_array_equal(_wav(body), want.audio_int16)
    status, headers, body = _req(addr, "POST", "/v1/audio/speech",
                                 dict(base, response_format="pcm"))
    assert status == 200 and body == want.audio_int16.tobytes()
    status, _, body = _req(addr, "POST", "/v1/audio/speech",
                           dict(base, response_format="pcm", stream=True))
    streamed = engine.synthesize("speech", language="english", seed=5,
                                 streaming=True, on_chunk=lambda a: None)
    assert status == 200 and body == streamed.audio_int16.tobytes()
    by_name = _req(addr, "POST", "/v1/audio/speech",
                   dict(base, voice="alice"))
    by_path = _req(addr, "POST", "/v1/audio/speech",
                   dict(base, voice=alice))
    assert by_name[0] == by_path[0] == 200 and by_name[2] == by_path[2]


@pytest.mark.parametrize("body, param", [
    ({"input": ""}, "input"),
    ({"input": "x", "response_format": "mp3"}, "response_format"),
    ({"input": "x", "speed": 1.5}, "speed"),
    ({"input": "x", "stream": True}, "response_format"),
    ({"input": "x", "language": "klingon"}, "language"),
    ({"input": "x", "max_tokens": 0}, "max_tokens"),
    ({"input": "x", "voice": "nobody"}, "voice"),
])
def test_openai_speech_400(gateway, body, param):
    _, addr, _ = gateway
    status, _, raw = _req(addr, "POST", "/v1/audio/speech", body)
    err = json.loads(raw)["error"]
    assert status == 400 and err["param"] == param
    assert err["type"] == "invalid_request_error"


def test_error_codes_400_413(gateway):
    """A body that is not JSON and a daemon error header are 400; a
    declared Content-Length past MAX_BODY_BYTES is 413 on both POST
    routes, refused before the body is read."""
    _, addr, _ = gateway
    status, _, body = _req(addr, "POST", "/v1/synthesize", b"{not json")
    assert status == 400 and "bad request body" in json.loads(body)["error"]
    status, _, body = _req(addr, "POST", "/v1/synthesize",
                           {"text": "x", "language": "klingon"})
    assert status == 400 and "language" in json.loads(body)["error"]
    for route in ("/v1/synthesize", "/v1/audio/speech"):
        c = http.client.HTTPConnection(*addr, timeout=60)
        c.putrequest("POST", route)
        c.putheader("Content-Length", str(thttp.MAX_BODY_BYTES + 1))
        c.endheaders()
        r = c.getresponse()
        assert r.status == 413, route
        r.read()
        c.close()


def test_overloaded_is_503(gateway):
    """A batched daemon whose batcher sheds every request (max_queue 0):
    503 with Retry-After on both routes, the native route keeping the
    daemon's {"code": "overloaded"}, the OpenAI route its
    "overloaded_error" type."""
    engine, _, _ = gateway
    b = ContinuousBatcher(engine.cfg, engine.params, batch_size=2,
                          dtype=torch.float32, device="cpu", max_queue=0)
    srv = thttp.serve_http(TTSDaemon(engine, "unused", batcher=b),
                           host="127.0.0.1", port=0)
    try:
        status, headers, body = _req(srv.server_address, "POST",
                                     "/v1/synthesize", {"text": "x"})
        assert status == 503 and headers["Retry-After"] == "1"
        assert json.loads(body)["code"] == "overloaded"
        status, headers, body = _req(srv.server_address, "POST",
                                     "/v1/audio/speech", {"input": "x"})
        assert status == 503 and headers["Retry-After"] == "1"
        assert json.loads(body)["error"]["type"] == "overloaded_error"
    finally:
        srv.shutdown()


def test_metrics_and_prometheus_text_match_jax(gateway):
    """GET /metrics parses as name/value lines after a request, and
    prometheus_text gives the JAX gateway's text for the same snapshot
    (counters, percentile summaries, nested batcher gauges, the mode)."""
    _, addr, _ = gateway
    _req(addr, "POST", "/v1/synthesize", {"text": "metrics", "seed": 1})
    status, headers, body = _req(addr, "GET", "/metrics")
    assert status == 200 and headers["Content-Type"].startswith("text/plain")
    metrics = dict(line.rsplit(" ", 1)
                   for line in body.decode().strip().split("\n"))
    assert float(metrics["qwen3_tts_requests_total"]) >= 1
    assert 'qwen3_tts_rtf{quantile="0.5"}' in metrics
    assert float(metrics['qwen3_tts_mode_info{mode="engine"}']) == 1
    snap = {"uptime_seconds": 12.5, "requests": 7, "errors": 1,
            "tokens": 90, "audio_seconds": 7.2,
            "total_seconds": {"p50": 0.5, "p95": 0.9, "n": 7},
            "rtf": {"p50": 0.2, "p95": 0.3, "n": 7},
            "first_audio_seconds": None, "mode": "batched",
            "batcher": {"batch_size": 4, "active_slots": 2, "queued": 0,
                        "paged": True, "free_pages": 12,
                        "prefix_cache": {"entries": 1, "capacity": 8,
                                         "hits": 3, "misses": 1}}}
    assert thttp.prometheus_text(snap) == jhttp.prometheus_text(snap)


def test_metrics_export_the_batchers_counters(gateway):
    """A batched daemon's /metrics carries every cumulative counter of
    the batcher (its own, the kernels' launches, the recorder's dropped
    entries) as qwen3_tts_batcher_<name>_total, and its prefix cache hits
    and misses as gauges, as {"cmd": "stats"} reports them."""
    engine, _, _ = gateway
    b = ContinuousBatcher(engine.cfg, engine.params, batch_size=2,
                          dtype=torch.float32, device="cpu")
    ids, n_text = engine._encode_text("counted")
    b.start()
    try:
        n_codes = len(b.submit(np.asarray(ids), int(n_text), seed=4,
                               max_tokens=4).result(timeout=120)[0])
    finally:
        b.stop()
    daemon = TTSDaemon(engine, "unused", batcher=b)
    srv = thttp.serve_http(daemon, host="127.0.0.1", port=0)
    try:
        status, _, body = _req(srv.server_address, "GET", "/metrics")
        _, _, stats = _req(srv.server_address, "GET", "/v1/stats")
    finally:
        srv.shutdown()
    assert status == 200
    metrics = dict(line.rsplit(" ", 1)
                   for line in body.decode().strip().split("\n"))
    counters = json.loads(stats)["batcher"]["counters"]
    assert {"chunks", "loop_steps", "row_steps", "codes_committed",
            "done_reads", "status_reads", "admissions", "prefix_misses",
            "spans_dropped"} | {f"launches_K{i}" for i in range(1, 6)} <= set(
        counters)
    assert counters["admissions"] == 1
    assert counters["codes_committed"] == n_codes
    for name, value in counters.items():
        assert float(metrics[f"qwen3_tts_batcher_{name}_total"]) == value
    assert "qwen3_tts_batcher_prefix_cache_hits" in metrics
    assert not any(k.startswith("qwen3_tts_batcher_counters") for k in metrics)
