"""HTTP gateway in front of the daemon's handler. Twin of
qwen3_tts_tpu/serve/http.py over the port's daemon (serve/daemon.py).

Every request becomes the daemon's JSON message and goes through
``TTSDaemon.handle``, so both tiers, paragraph mode, voices, per-request
``max_tokens``, stats and error sentinels behave as on the Unix socket.

Endpoints:
  GET  /health            -> 200 {"ok": true}
  GET  /v1/stats          -> 200 JSON, the daemon's stats snapshot
  GET  /metrics           -> 200 text/plain Prometheus exposition of the
      same snapshot (counters as *_total, percentile dicts as summary
      quantiles, batcher occupancy as gauges)
  POST /v1/synthesize     -> body: the daemon's JSON request object
      default: 200 audio/wav (metadata in X-Ttsrt-* headers)
      {"stream": true}: 200 chunked application/x-ttsrt-frames, the
      daemon's frame stream ([u32 frame_len][u32 hdr_len][JSON][int16])
      as the body, ending with the done-frame (HTTPFrameReader parses it)
  GET  /v1/models         -> 200 OpenAI-style model list ("qwen3-tts")
  GET  /v1/audio/voices   -> 200 "default" and the registry's names
  POST /v1/audio/speech   -> OpenAI-compatible: {"input", "voice",
      "response_format": "wav"|"pcm", "speed": 1.0, "stream"} plus
      {"language", "seed", "max_tokens", "long", "priority"} passed
      through. Stream: chunked raw pcm as it renders. Errors in the
      OpenAI envelope {"error": {"message", "type", "param"}}; 400 for
      what the client can fix, 413 for a body past MAX_BODY_BYTES, 503 +
      Retry-After ("overloaded_error") under the batcher's max_queue. A
      "voice" resolves through the registry first, then as a prompt_dir
      path. speed != 1.0 is refused.
  other paths             -> 404

ThreadingHTTPServer: one thread per connection, so concurrent batched
requests share the decode batch.
"""

from __future__ import annotations

import io
import json
import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from qwen3_tts_tpu_torch.config import SAMPLE_RATE, SUPPORTED_LANGUAGES
from qwen3_tts_tpu_torch.io import wav as wav_io
from qwen3_tts_tpu_torch.serve.daemon import (
    TTSDaemon,
    decode_response,
    encode_response,
)
from qwen3_tts_tpu_torch.serve.voices import is_prompt_dir


# ingest bound: POST bodies are
# JSON request objects — tiny; reject a declared Content-Length past this
# BEFORE reading the body. Same 1 MiB as the daemon's MAX_REQUEST_BYTES
# and the native loop's max_req (native/ttsrt.cc).
MAX_BODY_BYTES = 1 << 20


def _wav_bytes(audio_int16: np.ndarray) -> bytes:
    """A complete in-memory WAV file (mono, 24 kHz, s16le)."""
    buf = io.BytesIO()
    wav_io.write_wav(buf, audio_int16)
    return buf.getvalue()


class _Handler(BaseHTTPRequestHandler):
    daemon_ref: TTSDaemon = None   # set by serve_http
    protocol_version = "HTTP/1.1"
    # socket timeout (StreamRequestHandler.setup applies it to the
    # connection): without one, a stalled streaming client blocks
    # send_frame's wfile.write forever — and engine-mode synthesis runs
    # under the daemon's engine_lock, so one dead reader would wedge
    # every request on BOTH transports. 300 s matches the unix path
    # (daemon.py conn.settimeout). socket.timeout is an OSError, so the
    # daemon's existing dead-client guards catch it.
    timeout = 300.0

    def log_message(self, fmt, *args):   # quiet by default
        pass

    # -- helpers ------------------------------------------------------------

    def _json(self, code: int, obj: dict) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    # -- routes -------------------------------------------------------------

    def _stats_snapshot(self) -> dict:
        payload = self.daemon_ref.handle(b'{"cmd": "stats"}')
        header, _ = decode_response(payload)
        return header

    def do_GET(self):
        if self.path == "/health":
            return self._json(200, {"ok": True})
        if self.path == "/v1/stats":
            return self._json(200, self._stats_snapshot())
        if self.path == "/v1/models":
            # OpenAI SDKs list models during their handshake; advertise
            # one entry whose id the speech route accepts (and ignores —
            # there is exactly one model behind this daemon)
            return self._json(200, {
                "object": "list",
                "data": [{"id": "qwen3-tts", "object": "model",
                          "created": 0, "owned_by": "qwen3_tts_tpu_torch"}]})
        if self.path == "/v1/audio/voices":
            reg = self.daemon_ref.voices
            names = ["default"] + (reg.names() if reg is not None else [])
            return self._json(200, {
                "object": "list",
                "data": [{"name": n, "object": "voice"} for n in names]})
        if self.path == "/metrics":
            body = prometheus_text(self._stats_snapshot()).encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return None
        return self._json(404, {"error": f"no route {self.path!r}"})

    def _openai_error(self, code: int, message: str,
                      param: Optional[str] = None,
                      etype: str = "invalid_request_error",
                      retry_after: Optional[int] = None) -> None:
        body = json.dumps({"error": {"message": message,
                                     "type": etype,
                                     "param": param}}).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        if retry_after is not None:
            self.send_header("Retry-After", str(retry_after))
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _audio_speech(self) -> None:
        """OpenAI-compatible POST /v1/audio/speech (docstring above)."""
        try:
            n = int(self.headers.get("Content-Length", "0"))
        except (TypeError, ValueError) as e:
            return self._openai_error(400, f"bad Content-Length: {e}")
        if n > MAX_BODY_BYTES:
            # reject on the declared size alone — never read/allocate it
            # (and drop the connection: the unread body would garble a
            # keep-alive successor request)
            self.close_connection = True
            return self._openai_error(
                413, f"request body too large ({n} bytes > "
                f"{MAX_BODY_BYTES})")
        try:
            msg = json.loads(self.rfile.read(max(n, 0)).decode())
        except Exception as e:
            return self._openai_error(400, f"bad request body: {e}")

        text = msg.get("input")
        if not isinstance(text, str) or not text.strip():
            return self._openai_error(400, "'input' must be non-empty text",
                                      "input")
        fmt = msg.get("response_format", "wav")
        if fmt not in ("wav", "pcm"):
            return self._openai_error(
                400, f"response_format {fmt!r} unsupported (wav, pcm)",
                "response_format")
        speed = msg.get("speed", 1.0)
        if speed != 1.0:
            return self._openai_error(
                400, "speed != 1.0 is not supported (no time-stretch DSP)",
                "speed")
        stream = bool(msg.get("stream"))
        if stream and fmt == "wav":
            return self._openai_error(
                400, "streaming requires response_format 'pcm' (a WAV "
                "header needs the final length)", "response_format")

        # pre-validate everything the daemon/engine would reject, so
        # stream-mode failures surface as a 4xx status instead of an
        # empty chunked body (headers go out before handle() runs)
        language = msg.get("language", "russian")
        if language not in SUPPORTED_LANGUAGES:
            return self._openai_error(
                400, f"unsupported language {language!r}; expected one of "
                f"{SUPPORTED_LANGUAGES}", "language")
        try:
            seed = int(msg.get("seed") or 0)
        except (TypeError, ValueError):
            return self._openai_error(400, "seed must be an int", "seed")
        req = {"text": text, "language": language, "seed": seed}
        if "max_tokens" in msg and msg["max_tokens"] is not None:
            try:
                mt = int(msg["max_tokens"])
            except (TypeError, ValueError):
                return self._openai_error(400, "max_tokens must be an int",
                                          "max_tokens")
            if mt < 1:
                return self._openai_error(
                    400, f"max_tokens must be >= 1, got {mt}", "max_tokens")
            req["max_tokens"] = mt
        if "long" in msg:
            req["long"] = msg["long"]
        if "priority" in msg and msg["priority"] is not None:
            try:
                req["priority"] = int(msg["priority"])
            except (TypeError, ValueError):
                return self._openai_error(400, "priority must be an int",
                                          "priority")
        voice = msg.get("voice", "default")
        if voice not in ("default", "", None):
            if not isinstance(voice, str):
                return self._openai_error(400, "voice must be a string",
                                          "voice")
            # registry name first, raw prompt_dir path as the fallback
            reg = self.daemon_ref.voices
            resolved = reg.resolve(voice) if reg is not None else None
            if resolved is not None:
                req["prompt_dir"] = resolved
            elif is_prompt_dir(voice):
                req["prompt_dir"] = voice
            else:
                avail = ", ".join(
                    ["default"] + (reg.names() if reg is not None else []))
                return self._openai_error(
                    400, f"unknown voice {voice!r}: expected one of "
                    f"[{avail}] or a prompt_dir created by "
                    "encode_reference_audio (ref_codec_tokens.npy)",
                    "voice")
        raw = json.dumps(dict(req, stream=stream,
                              streaming=stream)).encode()

        if stream:
            self.send_response(200)
            self.send_header("Content-Type", "audio/pcm")
            self.send_header("X-Ttsrt-Sample-Rate", str(SAMPLE_RATE))
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            err: list = []

            def send_frame(frame: bytes) -> None:
                header, audio = decode_response(frame)
                if "error" in header:
                    err.append(header["error"])
                    return
                pcm = audio.tobytes()
                if pcm:
                    self.wfile.write(f"{len(pcm):x}\r\n".encode()
                                     + pcm + b"\r\n")
                    self.wfile.flush()

            resp = self.daemon_ref.handle(raw, send_frame)
            if resp is not None:
                # early failures come back as a blob, not via send_frame
                header, _ = decode_response(resp)
                if "error" in header:
                    err.append(header["error"])
            if err:
                # raw pcm has no frame envelope to carry the error, so
                # abort WITHOUT the chunked terminator: the client sees a
                # truncated transfer (IncompleteRead), never a clean EOF
                # indistinguishable from short audio
                self.log_error("stream aborted: %s", err[0])
                self.close_connection = True
                return None
            try:
                self.wfile.write(b"0\r\n\r\n")
            except OSError:
                # client vanished mid-stream: the daemon layer already
                # swallowed its send failure — an escaping raise here
                # would traceback-spam the server log per dead client
                self.close_connection = True
            return None

        payload = self.daemon_ref.handle(raw)
        header, audio = decode_response(payload)
        if "error" in header:
            # client-side params were pre-validated above, so anything
            # the daemon/engine rejects now is either the voice dir's
            # CONTENT (client-fixable -> 400) or a server fault (-> 500,
            # type server_error: OpenAI SDKs treat 4xx as non-retryable)
            m = str(header["error"])
            if header.get("code") == "overloaded":
                # batcher backpressure: retryable, the OpenAI SDKs'
                # overloaded_error + 503 + Retry-After contract
                return self._openai_error(503, m, None,
                                          etype="overloaded_error",
                                          retry_after=1)
            if "prompt_dir" in m:
                return self._openai_error(400, m, "voice")
            return self._openai_error(500, m, None, etype="server_error")
        body = _wav_bytes(audio) if fmt == "wav" else audio.tobytes()
        self.send_response(200)
        self.send_header("Content-Type",
                         "audio/wav" if fmt == "wav" else "audio/pcm")
        self.send_header("Content-Length", str(len(body)))
        self.send_header("X-Ttsrt-Sample-Rate", str(SAMPLE_RATE))
        self.end_headers()
        self.wfile.write(body)
        return None

    def do_POST(self):
        if self.path == "/v1/audio/speech":
            return self._audio_speech()
        if self.path != "/v1/synthesize":
            return self._json(404, {"error": f"no route {self.path!r}"})
        try:
            n = int(self.headers.get("Content-Length", "0"))
        except (TypeError, ValueError) as e:
            return self._json(400, {"error": f"bad Content-Length: {e}"})
        if n > MAX_BODY_BYTES:
            # reject on the declared size alone — never read/allocate it
            # (and drop the connection: the unread body would garble a
            # keep-alive successor request)
            self.close_connection = True
            return self._json(413, {"error": f"request body too large "
                                             f"({n} bytes > "
                                             f"{MAX_BODY_BYTES})"})
        try:
            raw = self.rfile.read(max(n, 0))
            msg = json.loads(raw.decode())
        except Exception as e:
            return self._json(400, {"error": f"bad request body: {e}"})

        if msg.get("stream"):
            # chunked transfer of the daemon's native frame stream; the
            # daemon handler writes frames as synthesis renders them
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ttsrt-frames")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def send_frame(frame: bytes) -> None:
                payload = struct.pack("<I", len(frame)) + frame
                self.wfile.write(f"{len(payload):x}\r\n".encode()
                                 + payload + b"\r\n")
                self.wfile.flush()

            resp = self.daemon_ref.handle(raw, send_frame)
            try:
                if resp is not None:
                    # early failures (empty text, bad params) come back
                    # as a blob instead of through send_frame — forward
                    # as the stream's terminal done-frame so HTTP clients
                    # see the error rather than a clean empty stream
                    header, _ = decode_response(resp)
                    send_frame(encode_response({"done": True, **header},
                                               None))
                self.wfile.write(b"0\r\n\r\n")
            except OSError:
                # dead mid-stream client: daemon already treated it as
                # handled — don't let the terminator write traceback
                self.close_connection = True
            return None

        payload = self.daemon_ref.handle(raw)
        header, audio = decode_response(payload)
        if "error" in header:
            if header.get("code") == "overloaded":
                # backpressure (batcher max_queue): the retryable signal
                body = json.dumps(header).encode()
                self.send_response(503)
                self.send_header("Content-Type", "application/json")
                self.send_header("Retry-After", "1")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return None
            return self._json(400, header)
        body = _wav_bytes(audio)
        self.send_response(200)
        self.send_header("Content-Type", "audio/wav")
        self.send_header("Content-Length", str(len(body)))
        for k, v in header.items():
            if v is not None:
                self.send_header(f"X-Ttsrt-{k.replace('_', '-')}", str(v))
        self.end_headers()
        self.wfile.write(body)
        return None


_COUNTERS = {"requests", "errors", "tokens"}  # monotonic -> *_total


def prometheus_text(snap: dict, prefix: str = "qwen3_tts") -> str:
    """Flatten the daemon's stats snapshot into Prometheus exposition
    format: scalars become gauges (counters get the *_total suffix),
    ``{"p50","p95","n"}`` percentile dicts become summary quantiles +
    _count, nested dicts (batcher occupancy) flatten with underscores,
    a nested ``counters`` dict (the batcher's cumulative counters) gives
    ``<path>_<name>_total``, and the ``mode`` string rides as a label on
    an info gauge."""
    lines = []

    def emit(name: str, value, labels: str = "") -> None:
        if isinstance(value, bool):
            value = int(value)
        if not isinstance(value, (int, float)):
            return
        lines.append(f"{name}{labels} {value}")

    def walk(d: dict, path: str) -> None:
        for k, v in d.items():
            name = f"{path}_{k}"
            if isinstance(v, dict) and k == "counters":
                for ck, cv in v.items():
                    emit(f"{path}_{ck}_total", cv)
            elif isinstance(v, dict):
                if {"p50", "p95"} <= set(v):
                    emit(name, v["p50"], '{quantile="0.5"}')
                    emit(name, v["p95"], '{quantile="0.95"}')
                    emit(name + "_count", v.get("n", 0))
                else:
                    walk(v, name)
            elif k == "mode":
                emit(f"{path}_mode_info", 1, f'{{mode="{v}"}}')
            elif k in _COUNTERS and path == prefix:
                emit(f"{name}_total", v)
            else:
                emit(name, v)

    walk(snap, prefix)
    return "\n".join(lines) + "\n"


class HTTPFrameReader:
    """Client-side parser for the streaming response body: yields
    (header dict, int16 audio) per daemon frame. Feed it the raw
    (de-chunked) body stream of a ``stream: true`` response."""

    def __init__(self, fileobj):
        self.f = fileobj

    def __iter__(self):
        while True:
            raw = self._read_exact(4)
            if raw is None:
                return
            (n,) = struct.unpack("<I", raw)
            frame = self._read_exact(n)
            if frame is None:
                return
            header, audio = decode_response(frame)
            yield header, audio
            if header.get("done"):
                # drain the body to its end (the chunked terminator) so
                # a keep-alive connection is reusable afterwards
                try:
                    self.f.read()
                except Exception:
                    pass
                return

    def _read_exact(self, n: int) -> Optional[bytes]:
        buf = b""
        while len(buf) < n:
            part = self.f.read(n - len(buf))
            if not part:
                return None
            buf += part
        return buf


def serve_http(daemon: TTSDaemon, host: str = "127.0.0.1",
               port: int = 8750,
               client_timeout: float = 300.0) -> ThreadingHTTPServer:
    """Start the HTTP gateway on a background thread; returns the server
    (call ``.shutdown()`` to stop). The daemon's ``handle`` does the
    work; this only owns the transport. ``client_timeout`` bounds every
    client socket read/write (see _Handler.timeout)."""
    handler = type("BoundHandler", (_Handler,),
                   {"daemon_ref": daemon, "timeout": client_timeout})
    srv = ThreadingHTTPServer((host, port), handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv
