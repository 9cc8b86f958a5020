"""Daemon mode: a resident synthesis server on a Unix socket. Twin of
qwen3_tts_tpu/serve/daemon.py over the port's engine and batcher.

    python -m qwen3_tts_tpu_torch.serve.daemon [--batch 4 --paged]
        [--http 8080] [--voices DIR] [--device cuda|cpu] [--profile DIR]

Two tiers: engine mode (default) serves one request at a time on
``TTSEngine`` through the native accept loop (runtime/native.py, libttsrt)
or the Python fallback; batched mode (``--batch N``) admits the requests
of concurrent connections, one thread each, into the continuous batcher
(serve/batching.py), where they decode together.
``--tp``/``--dp`` serve the batched tier over a dp x tp mesh: one rank
in this process, or, for more, ranks that this command starts, one a
device, whose rank 0 serves the socket and broadcasts every step's
admissions to the others (serve/lockstep.py). ``--profile DIR`` writes
one torch.profiler trace of the whole session (set-up, warm-up and
serving) into DIR at shutdown, with the program's spans as ranges
(utils/profiling.device_trace): the batcher's set-up and, per step,
its eviction, admissions, page top-up, dispatch and harvest.

Protocol (little-endian), the JAX daemon's:
  request:  [u32 len][JSON {"text", "language", "streaming", "seed",
                            "max_tokens"?, "prompt_dir"?, "voice"?,
                            "stream"?, "long"?, "priority"?}]
  ("voice": a name of the daemon's VoiceRegistry (--voices, serve/
  voices.py), resolved to its prompt dir here; "default" is the model's
  own voice. "prompt_dir": voice cloning by path, in both tiers.
  "max_tokens": the request's cap, clamped to cfg.max_tokens. "priority"
  (batched): higher admits first; past --max_queue waiting requests a
  request gets {"error", "code": "overloaded"} (HTTP: 503). "long": the
  text splits into sentence pieces; engine mode runs synthesize_long,
  batched mode submits every piece as a request of its own.)

  blob response (default):
    [u32 len][u32 hdr_len][JSON {"n_samples", "n_tokens", "rtf",
              "total_seconds", "error"?}][int16 audio...]

  chunked response ("stream": true), frames as the audio renders:
    repeat: [u32 frame_len][u32 hdr_len][JSON {"chunk": i,
                "n_samples"}][int16 audio...]
    final:  [u32 frame_len][u32 hdr_len][JSON {"done": true,
                "n_samples", "n_tokens", "rtf", "total_seconds",
                "first_audio_seconds", "error"?}]
"""

from __future__ import annotations

import collections
import json
import os
import queue
import socket
import struct
import sys
import threading
import time
from typing import Optional

import numpy as np

from qwen3_tts_tpu_torch.config import (
    SAMPLE_RATE,
    SAMPLES_PER_TOKEN,
    SUPPORTED_LANGUAGES,
)
from qwen3_tts_tpu_torch.models.vocoder import to_int16
from qwen3_tts_tpu_torch.serve.batching import OverloadedError
from qwen3_tts_tpu_torch.utils.text import (
    piece_token_budget,
    split_for_budget,
)

DEFAULT_SOCKET = "/tmp/qwen3_tts_tpu.sock"

# ingest bound of the Python accept loop: no allocation on a client's
# say-so. 1 MiB, the native loop's max_req (native/ttsrt.cc serve_unix).
MAX_REQUEST_BYTES = 1 << 20

# a batched request's bound on its wait for the batcher, in seconds
BATCHED_TIMEOUT = 600.0


class ServingStats:
    """Thread-safe serving counters for ``{"cmd": "stats"}``; percentiles
    over the most recent ``WINDOW`` requests."""

    WINDOW = 512

    def __init__(self):
        self._lock = threading.Lock()
        self.t_start = time.monotonic()
        self.requests = 0
        self.errors = 0
        self.tokens = 0
        self.audio_seconds = 0.0
        self._total_s = collections.deque(maxlen=self.WINDOW)
        self._rtf = collections.deque(maxlen=self.WINDOW)
        self._first_audio = collections.deque(maxlen=self.WINDOW)

    def record(self, n_tokens: int, total_seconds: float,
               rtf: float, first_audio: Optional[float] = None) -> None:
        with self._lock:
            self.requests += 1
            self.tokens += int(n_tokens)
            self.audio_seconds += n_tokens * SAMPLES_PER_TOKEN / SAMPLE_RATE
            self._total_s.append(float(total_seconds))
            if rtf == rtf and rtf != float("inf"):  # no NaN/inf (0 tokens)
                self._rtf.append(float(rtf))
            if first_audio is not None:
                self._first_audio.append(float(first_audio))

    def record_error(self) -> None:
        with self._lock:
            self.errors += 1

    @staticmethod
    def _pcts(xs) -> Optional[dict]:
        if not xs:
            return None
        a = np.sort(np.asarray(xs, np.float64))
        return {"p50": round(float(np.percentile(a, 50)), 4),
                "p95": round(float(np.percentile(a, 95)), 4),
                "n": int(len(a))}

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "uptime_seconds": round(time.monotonic() - self.t_start, 1),
                "requests": self.requests,
                "errors": self.errors,
                "tokens": self.tokens,
                "audio_seconds": round(self.audio_seconds, 2),
                "total_seconds": self._pcts(self._total_s),
                "rtf": self._pcts(self._rtf),
                "first_audio_seconds": self._pcts(self._first_audio),
            }


def encode_response(header: dict, audio_int16: Optional[np.ndarray]) -> bytes:
    hdr = json.dumps(header).encode()
    body = (audio_int16.astype("<i2").tobytes() if audio_int16 is not None
            else b"")
    return struct.pack("<I", len(hdr)) + hdr + body


def decode_response(payload: bytes):
    hdr_len = struct.unpack("<I", payload[:4])[0]
    header = json.loads(payload[4:4 + hdr_len].decode())
    audio = np.frombuffer(payload[4 + hdr_len:], dtype="<i2")
    return header, audio


def _send_done(send_frame, hdr: dict) -> None:
    """A stream's terminal frame; a client that is gone is not an error
    of the request (it was counted, or the request succeeded)."""
    try:
        send_frame(encode_response({"done": True, **hdr}, None))
    except OSError:
        pass


def _withdraw(futs) -> None:
    """Cancel the batcher requests not yet resolved: queued ones are
    skipped at admission, admitted ones evicted at the next chunk
    boundary, so no slot decodes for a client that is gone."""
    for f in futs:
        r = getattr(f, "request", None)
        if r is not None and not f.done():
            r.cancelled = True


class TTSDaemon:
    """Resident synthesis daemon over a port ``TTSEngine``; with a
    ``batcher`` (serve/batching.ContinuousBatcher) the batched tier.
    ``voices``: a serve/voices.VoiceRegistry, or None."""

    def __init__(self, engine, socket_path: str = DEFAULT_SOCKET,
                 batcher=None, voices=None):
        self.engine = engine
        self.socket_path = socket_path
        self.batcher = batcher
        self.voices = voices
        self.stats = ServingStats()
        self._stop = threading.Event()
        self._native_serving = False
        # engine mode serves one request at a time, over both transports
        self.engine_lock = threading.Lock()

    # -- request handling ---------------------------------------------------

    def handle(self, req: bytes, send_frame=None) -> Optional[bytes]:
        """Serve one request. Returns the blob response, or None after
        writing chunked frames through ``send_frame`` ("stream" mode)."""
        try:
            msg = json.loads(req.decode())
            if msg.get("cmd") == "stats":
                snap = self.stats.snapshot()
                if self.batcher is not None:
                    snap["batcher"] = self.batcher.occupancy()
                snap["mode"] = ("batched" if self.batcher is not None
                                else "engine")
                return encode_response(snap, None)
            text = msg.get("text", "")
            if not text:
                self.stats.record_error()
                return encode_response({"error": "empty text"}, None)
            voice = msg.get("voice")
            if voice not in (None, "", "default"):
                if msg.get("prompt_dir"):
                    raise ValueError(
                        "give 'voice' or 'prompt_dir', not both")
                pd = (self.voices.resolve(voice)
                      if self.voices is not None else None)
                if pd is None:
                    avail = (", ".join(self.voices.names())
                             if self.voices is not None and len(self.voices)
                             else "none registered")
                    raise ValueError(f"unknown voice {voice!r} "
                                     f"(available: {avail})")
                msg["prompt_dir"] = pd
            mt = msg.get("max_tokens")
            mt = int(mt) if mt is not None else None
            if self.batcher is not None:
                return self._handle_batched(
                    msg, text, mt,
                    send_frame if msg.get("stream") else None)
            with self.engine_lock:
                return self._handle_engine(msg, text, mt, send_frame)
        except Exception as e:
            self.stats.record_error()
            hdr = {"error": str(e)}
            if isinstance(e, OverloadedError):
                hdr["code"] = "overloaded"
            if send_frame is not None:
                _send_done(send_frame, hdr)
                return None
            return encode_response(hdr, None)

    def _handle_engine(self, msg, text, mt, send_frame) -> Optional[bytes]:
        try:
            if msg.get("stream") and send_frame is not None:
                return self._handle_stream(msg, text, mt, send_frame)
            kw = dict(language=msg.get("language", "russian"),
                      seed=int(msg.get("seed", 0)),
                      prompt_dir=msg.get("prompt_dir"), max_tokens=mt)
            if msg.get("long"):
                res = self.engine.synthesize_long(text, **kw)
            else:
                res = self.engine.synthesize(
                    text, streaming=bool(msg.get("streaming", False)), **kw)
            header = {
                "n_samples": int(len(res.audio_int16)),
                "n_tokens": int(res.n_tokens),
                "rtf": float(res.rtf),
                "total_seconds": float(res.total_seconds),
            }
            self.stats.record(res.n_tokens, res.total_seconds, res.rtf,
                              res.first_audio_seconds)
            return encode_response(header, res.audio_int16)
        except Exception as e:
            self.stats.record_error()
            return encode_response({"error": str(e)}, None)

    def _handle_stream(self, msg, text: str, mt, send_frame) -> None:
        """Chunked-response synthesis: each piece of audio the engine
        emits leaves as a frame at once."""
        idx = 0

        def on_chunk(audio_i16: np.ndarray) -> None:
            nonlocal idx
            send_frame(encode_response(
                {"chunk": idx, "n_samples": int(len(audio_i16))},
                audio_i16))
            idx += 1

        kw = dict(language=msg.get("language", "russian"),
                  seed=int(msg.get("seed", 0)), on_chunk=on_chunk,
                  prompt_dir=msg.get("prompt_dir"), max_tokens=mt)
        try:
            if msg.get("long"):
                # the first sentence streams through the head schedule,
                # later sentences one frame each
                res = self.engine.synthesize_long(text, **kw)
            else:
                res = self.engine.synthesize(text, streaming=True, **kw)
            self.stats.record(res.n_tokens, res.total_seconds, res.rtf,
                              res.first_audio_seconds)
            _send_done(send_frame, {
                "n_samples": int(len(res.audio_int16)),
                "n_tokens": int(res.n_tokens),
                "rtf": float(res.rtf),
                "total_seconds": float(res.total_seconds),
                "first_audio_seconds": res.first_audio_seconds,
            })
        except Exception as e:
            self.stats.record_error()
            _send_done(send_frame, {"error": str(e)})
        return None

    def _encode_with_prompt(self, text: str, prompt_dir, preloaded=None):
        """A batched request's (ids, n_text, ref_codes | None, n_target |
        None) for ContinuousBatcher.submit, tokenized as the engine's
        prompt_dir path does (engine._encode_cloned). ``preloaded``: an
        already-loaded (ref_codes, ref_text) pair. Raises ValueError on a
        bad prompt_dir or a cloned text that overflows the prefix."""
        if not prompt_dir and preloaded is None:
            ids, n_text = self.engine._encode_text(text)
            return ids, n_text, None, None
        ref_codes, ref_text = (preloaded if preloaded is not None
                               else self.engine._load_prompt(prompt_dir))
        ids, n_text, n_target = self.engine._encode_cloned(text, ref_text)
        return ids, n_text, ref_codes, n_target

    def _reject(self, message: str, send_frame) -> Optional[bytes]:
        """A batched request refused before or while it was served: a
        terminal done-frame for a stream, an error header for a blob."""
        self.stats.record_error()
        if send_frame is not None:
            _send_done(send_frame, {"error": message})
            return None
        return encode_response({"error": message}, None)

    def _finish(self, header: dict, audio_i16, first_audio,
                send_frame) -> Optional[bytes]:
        self.stats.record(header["n_tokens"], header["total_seconds"],
                          header["rtf"], first_audio)
        if send_frame is not None:
            _send_done(send_frame,
                       {"first_audio_seconds": first_audio, **header})
            return None
        return encode_response(header, audio_i16)

    def _handle_batched(self, msg, text: str, mt=None,
                        send_frame=None) -> Optional[bytes]:
        """A batched-mode request. With ``send_frame`` ("stream": true)
        the batcher's stream segments leave as frames at decode-chunk
        cadence."""
        lang = msg.get("language", "russian")
        if lang not in SUPPORTED_LANGUAGES:
            return self._reject(f"unsupported language {lang!r}",
                                send_frame)
        if mt is not None and mt < 1:
            return self._reject(f"max_tokens must be >= 1, got {mt}",
                                send_frame)
        if msg.get("long"):
            return self._handle_batched_long(msg, text, mt, send_frame)
        t0 = time.perf_counter()
        first_audio = None
        on_chunk = seg_q = None
        if send_frame is not None:
            # on_chunk runs on the batcher's scheduler thread and must not
            # block (a stalled client would freeze the whole batch): the
            # segments queue here and this connection's thread sends them
            seg_q = queue.Queue()

            def on_chunk(seg: np.ndarray) -> None:
                nonlocal first_audio
                if first_audio is None:
                    first_audio = time.perf_counter() - t0
                seg_q.put(seg)

        try:
            ids, n_text, ref_codes, n_target = self._encode_with_prompt(
                text, msg.get("prompt_dir"))
        except ValueError as e:
            return self._reject(str(e), send_frame)
        # max_tokens is the slot's own budget: it stops decoding there
        fut = self.batcher.submit(np.asarray(ids), int(n_text),
                                  seed=int(msg.get("seed", 0)),
                                  max_tokens=mt, on_chunk=on_chunk,
                                  ref_codes=ref_codes, n_target=n_target,
                                  priority=int(msg.get("priority", 0)))
        idx = 0

        def drain(block: bool) -> None:
            nonlocal idx
            while True:
                try:
                    seg = seg_q.get(timeout=0.1) if block else \
                        seg_q.get_nowait()
                except queue.Empty:
                    return
                a16 = to_int16(seg)
                send_frame(encode_response(
                    {"chunk": idx, "n_samples": int(len(a16))}, a16))
                idx += 1
                block = False

        timeout_s = BATCHED_TIMEOUT
        try:
            if seg_q is not None:
                deadline = time.monotonic() + timeout_s
                while not fut.done():
                    drain(block=True)
                    if time.monotonic() > deadline:
                        raise TimeoutError("batched synthesis timed out")
                drain(block=False)
                timeout_s = max(deadline - time.monotonic(), 1.0)
            codes, audio = fut.result(timeout=timeout_s)
        except Exception as e:
            _withdraw([fut])
            if send_frame is not None:
                return self._reject(str(e), send_frame)
            raise    # handle() records it once
        audio_i16 = to_int16(audio)
        total = time.perf_counter() - t0
        dur = len(audio_i16) / SAMPLE_RATE
        header = {
            "n_samples": int(len(audio_i16)),
            "n_tokens": int(len(codes)),
            "rtf": (total / dur) if dur > 0 else float("inf"),
            "total_seconds": total,
        }
        return self._finish(header, audio_i16, first_audio, send_frame)

    def _handle_batched_long(self, msg, text: str, mt=None,
                             send_frame=None) -> Optional[bytes]:
        """A paragraph in batched mode: every sentence piece is a batcher
        request of its own (they decode together), the results stitched
        in order; in stream mode each finished piece is one frame."""
        t0 = time.perf_counter()
        seed = int(msg.get("seed", 0))
        # pieces bounded by their encoded token count (the engine's
        # synthesize_long rule); max_tokens tightens every piece
        budget = piece_token_budget(self.engine.cfg.max_tokens, mt)
        tok = self.engine.tokenizer
        # prompt_dir applies to every piece: loaded and checked once,
        # and the split leaves room for the reference transcript
        prompt_dir = msg.get("prompt_dir")
        preloaded = None
        if prompt_dir:
            try:
                preloaded = self.engine._load_prompt(prompt_dir)
                budget = self.engine._cloned_piece_budget(budget,
                                                          preloaded[1])
            except ValueError as e:
                return self._reject(str(e), send_frame)
        pieces = split_for_budget(
            text, lambda s: len(tok.encode(s, add_special_tokens=False)),
            budget) or [text]
        futs = []
        try:
            for i, p in enumerate(pieces):
                ids, n, ref_codes, n_target = self._encode_with_prompt(
                    p, prompt_dir, preloaded=preloaded)
                futs.append(self.batcher.submit(
                    np.asarray(ids), int(n), seed=seed + i, max_tokens=mt,
                    ref_codes=ref_codes, n_target=n_target,
                    priority=int(msg.get("priority", 0))))
        except (ValueError, OverloadedError) as e:
            _withdraw(futs)
            if isinstance(e, OverloadedError):
                raise    # handle() tags it "overloaded"
            return self._reject(str(e), send_frame)
        parts_codes, parts_audio = [], []
        first_audio = None
        idx = 0
        try:
            for f in futs:
                codes, audio = f.result(timeout=BATCHED_TIMEOUT)
                a16 = to_int16(audio)
                if first_audio is None and len(a16) > 0:
                    first_audio = time.perf_counter() - t0
                parts_codes.append(codes)
                parts_audio.append(a16)
                if send_frame is not None and len(a16) > 0:
                    send_frame(encode_response(
                        {"chunk": idx, "n_samples": int(len(a16))}, a16))
                    idx += 1
        except Exception as e:
            _withdraw(futs)
            return self._reject(str(e), send_frame)
        audio_i16 = (np.concatenate(parts_audio) if parts_audio
                     else np.zeros(0, np.int16))
        n_tokens = int(sum(len(c) for c in parts_codes))
        total = time.perf_counter() - t0
        dur = len(audio_i16) / SAMPLE_RATE
        header = {
            "n_samples": int(len(audio_i16)),
            "n_tokens": n_tokens,
            "n_sentences": len(pieces),
            "rtf": (total / dur) if dur > 0 else float("inf"),
            "total_seconds": total,
        }
        return self._finish(header, audio_i16, first_audio, send_frame)

    # -- serve loops --------------------------------------------------------

    def serve(self, native_loop: bool = True) -> None:
        """Blocks until stop(). Engine mode uses the native accept loop
        when the library is available; batched mode always runs the
        threaded Python loop (concurrent connections must overlap to
        share a decode batch) and stops the batcher on its way out."""
        from qwen3_tts_tpu_torch.runtime import native
        if self.batcher is not None:
            self.batcher.start()
            try:
                self._serve_python(threaded=True)
            finally:
                self.batcher.stop()
            return
        if native_loop and native.available():
            if self._stop.is_set():
                return
            # re-arm the process-global native stop flag outside the C
            # loop, then check again: a stop() racing the entry wins
            native.serve_reset()
            if self._stop.is_set():
                return
            self._native_serving = True
            try:
                rc = native.serve_unix(self.socket_path, self.handle)
            finally:
                self._native_serving = False
            if rc != 0 and not self._stop.is_set():
                raise RuntimeError(
                    f"native serve loop failed (rc={rc}) on "
                    f"{self.socket_path}")
            return
        self._serve_python()

    def _serve_python(self, threaded: bool = False) -> None:
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.bind(self.socket_path)
        sock.listen(16)
        sock.settimeout(1.0)
        os.chmod(self.socket_path, 0o666)

        def serve_conn(conn):
            try:
                raw = _recv_exact(conn, 4)
                if raw is None:
                    return
                n = struct.unpack("<I", raw)[0]
                if n > MAX_REQUEST_BYTES:
                    # refused on the declared length, before any read
                    payload = encode_response(
                        {"error": f"request too large ({n} bytes > "
                                  f"{MAX_REQUEST_BYTES})",
                         "code": "too_large"}, None)
                    conn.sendall(struct.pack("<I", len(payload)) + payload)
                    return
                req = _recv_exact(conn, n)
                if req is None:
                    return

                def send_frame(payload: bytes) -> None:
                    conn.sendall(struct.pack("<I", len(payload)) + payload)

                resp = self.handle(req, send_frame)
                if resp is not None:
                    send_frame(resp)
            except OSError:
                pass    # the client went away
            finally:
                conn.close()

        try:
            while not self._stop.is_set():
                try:
                    conn, _ = sock.accept()
                except socket.timeout:
                    continue
                # accept() on a listener with a timeout gives a blocking
                # socket: bound it, or one stalled client wedges the loop
                conn.settimeout(300.0)
                if threaded:
                    threading.Thread(target=serve_conn, args=(conn,),
                                     daemon=True).start()
                else:
                    serve_conn(conn)
        finally:
            sock.close()
            if os.path.exists(self.socket_path):
                os.unlink(self.socket_path)

    def stop(self) -> None:
        self._stop.set()
        from qwen3_tts_tpu_torch.runtime import native
        native.serve_stop()
        if self._native_serving:
            # the native loop reads its stop flag between accepts, which
            # a 1 s SO_RCVTIMEO bounds only where the kernel applies it
            # to accept(); one connection wakes the loop everywhere
            try:
                with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as c:
                    c.settimeout(1.0)
                    c.connect(self.socket_path)
            except OSError:
                pass


def _recv_exact(conn, n: int) -> Optional[bytes]:
    data = b""
    while len(data) < n:
        chunk = conn.recv(n - len(data))
        if not chunk:
            return None
        data += chunk
    return data


class DaemonClient:
    """Client of TTSDaemon."""

    def __init__(self, socket_path: str = DEFAULT_SOCKET):
        self.socket_path = socket_path

    def _connect(self) -> socket.socket:
        # the daemon may still be binding right after start
        c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        for attempt in range(5):
            try:
                c.connect(self.socket_path)
                return c
            except (ConnectionRefusedError, FileNotFoundError):
                if attempt == 4:
                    c.close()
                    raise
                time.sleep(0.3 * (attempt + 1))

    @staticmethod
    def _recv_frame(c, what: str) -> bytes:
        raw = _recv_exact(c, 4)
        if raw is None:
            raise RuntimeError(f"daemon closed the connection {what}")
        payload = _recv_exact(c, struct.unpack("<I", raw)[0])
        if payload is None:
            raise RuntimeError(f"daemon closed the connection {what}")
        return payload

    def stats(self) -> dict:
        """The daemon's serving counters (``{"cmd": "stats"}``)."""
        msg = json.dumps({"cmd": "stats"}).encode()
        c = self._connect()
        try:
            c.sendall(struct.pack("<I", len(msg)) + msg)
            header, _ = decode_response(self._recv_frame(c, "before reply"))
            return header
        finally:
            c.close()

    def synthesize(self, text: str, language: str = "russian",
                   streaming: bool = False, seed: int = 0,
                   prompt_dir=None, max_tokens=None,
                   stream: bool = False, on_chunk=None,
                   long: bool = False, voice=None):
        """``stream=True`` asks for chunked frames (``on_chunk(header,
        audio)`` per frame); ``voice``, a name of the daemon's voice
        registry. Returns the final header and the whole int16
        audio either way; an error header raises RuntimeError."""
        req = {"text": text, "language": language,
               "streaming": streaming or stream, "seed": seed,
               "prompt_dir": prompt_dir}
        if max_tokens is not None:
            req["max_tokens"] = int(max_tokens)
        if stream:
            req["stream"] = True
        if long:
            req["long"] = True
        if voice is not None:
            req["voice"] = voice
        msg = json.dumps(req).encode()
        c = self._connect()
        try:
            c.sendall(struct.pack("<I", len(msg)) + msg)
            if not stream:
                header, audio = decode_response(
                    self._recv_frame(c, "before reply"))
                if "error" in header:
                    raise RuntimeError(header["error"])
                return header, audio
            parts = []
            while True:
                header, audio = decode_response(
                    self._recv_frame(c, "mid-stream"))
                if on_chunk is not None:
                    on_chunk(header, audio)
                if "error" in header:
                    raise RuntimeError(header["error"])
                if header.get("done"):
                    return header, (np.concatenate(parts) if parts
                                    else np.zeros(0, np.int16))
                parts.append(audio)
        finally:
            c.close()


def parser():
    import argparse

    p = argparse.ArgumentParser(
        description="Qwen3-TTS daemon (PyTorch port; the card by default)")
    p.add_argument("--socket", default=DEFAULT_SOCKET)
    p.add_argument("--model_dir", default=None)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--tiny", action="store_true",
                   help="the tiny test geometry (seconds on the CPU)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--python_loop", action="store_true",
                   help="use the pure-Python accept loop")
    p.add_argument("--batch", type=int, default=0,
                   help="continuous batching with N slots (concurrent "
                        "requests decode together); 0: engine mode")
    p.add_argument("--decode_chunk", type=int, default=32,
                   help="batched mode: decode steps per scheduler "
                        "iteration (larger: more throughput; smaller: "
                        "earlier admission)")
    p.add_argument("--paged", action="store_true",
                   help="batched mode over a block-paged KV pool (K4)")
    p.add_argument("--page_size", type=int, default=64)
    p.add_argument("--pipeline_depth", type=int, default=2, choices=[1, 2],
                   help="batched mode: 2 dispatches the next decode chunk "
                        "before it harvests the previous one; 1 surfaces "
                        "every frame one chunk earlier")
    p.add_argument("--tp", type=int, default=0, metavar="N",
                   help="batched mode over a dp x tp mesh (parallel/"
                        "mesh.py; tp groups never cross a host), one rank "
                        "a device, started by this command (rank 0 serves "
                        "the socket; serve/lockstep.py). Requires --batch. "
                        "0 (default): no mesh")
    p.add_argument("--dp", type=int, default=0, metavar="N",
                   help="batched mode: the mesh's dp extent (slots split "
                        "over dp; --batch must divide by it); by default "
                        "every card of this host over tp (1 on the CPU). "
                        "Requires --batch")
    p.add_argument("--max_queue", type=int, default=0,
                   help="batched mode: refuse new requests once this many "
                        "wait ('overloaded'; HTTP 503); 0: unbounded")
    p.add_argument("--prefix_cache", type=int, default=8,
                   help="batched mode: admission prefix LRU entries (0 "
                        "disables)")
    p.add_argument("--quantize", default=None,
                   choices=[None, "int8", "int8-cp"],
                   help="weight-only int8 (engine mode; see cli.py)")
    p.add_argument("--voices", default=None, metavar="DIR",
                   help="voice registry root: every subdirectory holding "
                        "ref_codec_tokens.npy is a voice by its name")
    p.add_argument("--http", type=int, default=0, metavar="PORT",
                   help="also serve HTTP on 127.0.0.1:PORT "
                        "(serve/http.py)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the session, the "
                        "program's spans as ranges, to DIR at shutdown "
                        "(one process: not with several --tp/--dp ranks; "
                        "the profiler holds every event in memory, so for "
                        "short sessions)")
    return p


def main(argv=None) -> int:
    p = parser()
    args = p.parse_args(argv)
    mesh = None
    if args.tp > 0 or args.dp > 0:
        if args.batch <= 0:
            p.error("--dp/--tp shard the batched tier; pass --batch N too")
        if args.dp > 0 and args.batch % args.dp:
            p.error(f"--batch {args.batch} not divisible by mesh "
                    f"dp={args.dp} (slots shard over dp)")
        if int(os.environ.get("QWEN3_TTS_NUM_PROCESSES", "1")) > 1:
            # this command starts its own ranks (serve/lockstep.py); a
            # world set up around it would serve each rank's own arrivals
            p.error(
                "multi-process daemon serving is not supported: the "
                "socket daemon dispatches from per-process request "
                "arrivals, which violates multi-controller lockstep. "
                "Run one daemon per host (it starts its own ranks for "
                "--tp/--dp), or drive the batcher's lockstep "
                "multi-process mode directly")
        tp = args.tp or 1
        if args.dp > 0:
            dp = args.dp
        elif args.device == "cpu":
            dp = 1
        else:
            import torch
            dp = max(torch.cuda.device_count() // tp, 1)
        if args.batch % dp:
            p.error(f"--batch {args.batch} not divisible by mesh dp={dp} "
                    "(slots shard over dp)")
        from qwen3_tts_tpu_torch.parallel import multihost as mh
        if dp * tp > 1:
            if args.profile:
                p.error("--profile traces one process, not the ranks of "
                        f"a dp{dp}xtp{tp} mesh")
            if args.device != "cpu":
                import torch
                # every rank needs a card of its own (the first N of this
                # host's): fail here, not in N processes
                cards = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
                try:
                    mh.make_serving_mesh(tp=tp, dp=dp,
                                         devices=cards[:dp * tp])
                except ValueError as e:
                    p.error(str(e))
            return _launch_ranks(dp * tp, argv)
        mesh = mh.make_serving_mesh(tp=1, dp=1, devices=[args.device])
        print(f"mesh dp{mesh.shape['dp']}xtp{mesh.shape['tp']} over "
              f"{mesh.devices.size} device(s)", flush=True)
    from qwen3_tts_tpu_torch.utils.profiling import device_trace
    with device_trace(args.profile,
                      mesh.device if mesh is not None else args.device):
        engine, batcher = build(args, mesh)
        return serve_main(args, engine, batcher)


def _launch_ranks(n: int, argv) -> int:
    """Start the n ranks of a multi-rank batched daemon (serve/lockstep.
    rank_main over this command line, through multihost.run_own_ranks)
    and wait for them; SIGTERM and SIGINT go on to rank 0, which drains
    and stops every rank. Returns the failing rank's exit code, else
    0."""
    import signal

    from qwen3_tts_tpu_torch.parallel import multihost as mh
    procs: list = []

    def forward(signum, frame):
        if procs and procs[0].poll() is None:
            procs[0].send_signal(signum)

    old = {s: signal.signal(s, forward)
           for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        return mh.run_own_ranks(
            "qwen3_tts_tpu_torch.serve.lockstep",
            list(sys.argv[1:] if argv is None else argv), n, "daemon",
            on_start=procs.extend)
    finally:
        for s, h in old.items():
            signal.signal(s, h)


def build(args, mesh, max_queue="args"):
    """The engine and, with ``--batch``, the batcher of a daemon command
    line (on ``mesh`` when given). ``max_queue``: the batcher's bound
    (``--max_queue`` by default; None on a lockstep rank, whose front end
    decides)."""
    import torch

    from qwen3_tts_tpu_torch.config import TTSConfig, tiny_tts_config
    from qwen3_tts_tpu_torch.engine.engine import TTSEngine

    if args.tiny:
        cfg = tiny_tts_config(max_tokens=32)
    else:
        # None: TTSEngine takes the geometry from the checkpoint
        cfg = None if args.model_dir else TTSConfig()
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    quantize = args.quantize
    if quantize and args.batch > 0:
        if mesh is None or mesh.rank == 0:
            print("--quantize ignored with --batch > 0 (the batched tier "
                  "is bf16, its code predictor int8)", flush=True)
        quantize = None
    device = mesh.device if mesh is not None else args.device
    engine = TTSEngine(cfg, model_dir=args.model_dir, dtype=dtype,
                       quantize=quantize, device=device)
    if args.batch <= 0:
        return engine, None
    from qwen3_tts_tpu_torch.serve.batching import ContinuousBatcher
    if max_queue == "args":
        max_queue = args.max_queue if args.max_queue > 0 else None
    batcher = ContinuousBatcher(
        engine.cfg, engine.params, batch_size=args.batch, dtype=dtype,
        decode_chunk=args.decode_chunk, paged=args.paged,
        page_size=args.page_size, pipeline_depth=args.pipeline_depth,
        prefix_cache=args.prefix_cache, max_queue=max_queue,
        device=device, mesh=mesh)
    return engine, batcher


def serve_main(args, engine, batcher) -> int:
    """Warm up through the tier that serves, then serve the socket (and
    HTTP) until SIGTERM/SIGINT. ``batcher``: a ContinuousBatcher, a
    serve/lockstep.LockstepFront (rank 0 of a multi-rank daemon) or
    None (engine mode). Returns the exit code."""
    import signal

    # warm up through the tier that serves, before the socket is bound
    if batcher is not None:
        batcher.start()
        ids, n_text = engine._encode_text("warmup")
        batcher.submit(np.asarray(ids), int(n_text),
                       seed=0).result(timeout=1800)
    else:
        engine.synthesize("warmup", language="english", seed=0)
    voices = None
    if args.voices:
        from qwen3_tts_tpu_torch.serve.voices import VoiceRegistry
        voices = VoiceRegistry(args.voices)
        print(f"voice registry: {len(voices)} voice(s) {voices.names()}",
              flush=True)
    daemon = TTSDaemon(engine, args.socket, batcher=batcher, voices=voices)
    if hasattr(batcher, "on_failure"):
        # a failed lockstep step ends the world: stop serving
        batcher.on_failure = daemon.stop
    srv = None
    if args.http:
        from qwen3_tts_tpu_torch.serve.http import serve_http
        srv = serve_http(daemon, port=args.http)
        print(f"HTTP gateway on http://127.0.0.1:{srv.server_address[1]}",
              flush=True)

    # SIGTERM/SIGINT stop the daemon. The serve loop runs on a worker
    # thread, because the native loop blocks inside a C call and a Python
    # signal handler runs only on the main thread between bytecodes; the
    # batched tier's serve() drains the batcher on its way out.
    def _on_signal(signum, frame):
        print(f"signal {signum}: shutting down", flush=True)
        daemon.stop()

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, _on_signal)

    print(f"TTS daemon listening on {args.socket}", flush=True)
    serve_error: list = []

    def _serve():
        try:
            daemon.serve(native_loop=not args.python_loop)
        except BaseException as e:   # reported through main's exit code
            serve_error.append(e)

    server = threading.Thread(target=_serve, daemon=True)
    server.start()
    try:
        while server.is_alive():
            server.join(timeout=0.5)
    finally:
        daemon.stop()
        server.join(timeout=30.0)
        if srv is not None:
            srv.shutdown()
    if serve_error:
        print(f"serve loop failed: {serve_error[0]!r}", flush=True)
        return 1
    error = getattr(batcher, "error", None)
    if error is not None:
        print(f"lockstep thread failed: {error!r}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
