"""Reference-protocol compatibility servers: the reference's three
Unix-socket protocols over the port's models, so a client written for the
reference runs against the port. Twin of qwen3_tts_tpu/serve/compat.py.

- **talker** (stateful, both ways per request):
    req:  [u32 len][JSON {"text", "language"}]
    per token: send [i32 code_0][f32 x H hidden]; recv [f32 x H feedback]
    end:  [i32 -1] done / [i32 -2] error
- **code predictor** (stateless, one connection per token):
    req:  [f32 x H hidden][i32 code_0]  ->  resp: [i32 x 15]
- **vocoder** (batch):
    req:  [i32 n][i64 n*16 codes]  ->  resp: [i32 n_samples][i16 ...]

They run the engine's modules unfused at the protocol boundaries: the
talker's prefill, ``codec_logits`` and ``decode_step`` (K3 on an int8
talker), the code predictor's ``predict_codes`` (K2 on an int8 code
predictor), ``sample_code0``, and the vocoder through
``synthesize_chunked`` (the reference's crossfade). Every request draws
from a key of its own, taken from ``os.urandom``, through the port's keyed
draws.
"""

from __future__ import annotations

import json
import os
import socket
import struct
import sys
import threading
import traceback

import numpy as np
import torch

from qwen3_tts_tpu_torch.config import (
    CODEC_EOS_ID,
    NUM_AUDIO_CODES,
    VOC_CHUNK_SIZE,
    VOC_OVERLAP,
    TTSConfig,
)
from qwen3_tts_tpu_torch.models import code_predictor as cp
from qwen3_tts_tpu_torch.models import talker as tk
from qwen3_tts_tpu_torch.models import transformer as tfm
from qwen3_tts_tpu_torch.models import vocoder as voc
from qwen3_tts_tpu_torch.ops import sampling as smp
from qwen3_tts_tpu_torch.serve.daemon import _recv_exact

SENTINEL_DONE = -1
SENTINEL_ERROR = -2
MAX_TALKER_REQUEST = 65536     # the reference talker's bound, bytes
MAX_VOCODER_TOKENS = 10000     # the reference vocoder's bound


def _urandom_key(device) -> torch.Tensor:
    """A request's (1,) int64 row key from os.urandom."""
    return smp.batch_keys([int.from_bytes(os.urandom(8), "little")], 1,
                          device)


class _SocketServer:
    """Accept loop with a 1 s timeout that polls a stop flag. A
    connection is served inline on the accept thread (the reference
    servers serve one request at a time), with a socket timeout, so a
    stalled client cannot wedge the server."""

    conn_timeout = 300.0

    def __init__(self, socket_path: str):
        self.socket_path = socket_path
        self._stop = threading.Event()

    def stop(self):
        self._stop.set()

    def serve(self):
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.bind(self.socket_path)
        sock.listen(4)
        sock.settimeout(1.0)
        os.chmod(self.socket_path, 0o666)
        try:
            while not self._stop.is_set():
                try:
                    conn, _ = sock.accept()
                except socket.timeout:
                    continue
                try:
                    conn.settimeout(self.conn_timeout)
                    with torch.inference_mode():
                        self.handle(conn)
                except OSError:
                    pass    # the client went away
                except Exception:
                    # a request the models refuse (a code out of range)
                    # ends its connection, not the server
                    traceback.print_exc()
                finally:
                    conn.close()
        finally:
            sock.close()
            if os.path.exists(self.socket_path):
                os.unlink(self.socket_path)

    def handle(self, conn):  # pragma: no cover - abstract
        raise NotImplementedError


class TalkerCompatServer(_SocketServer):
    """The talker protocol over the port's talker. ``params``: the port's
    weight trees (io/weights.py), on ``device``."""

    def __init__(self, params, cfg: TTSConfig, tokenizer,
                 socket_path: str = "/tmp/qwen3_talker.sock",
                 device="cuda"):
        super().__init__(socket_path)
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.device = torch.device(device)
        self._tp = tk.Talker(cfg.talker, params["talker"]).to(
            self.device).weights()
        tcfg = cfg.talker
        self._rope = tfm.rope_cos_sin(
            torch.arange(tcfg.max_seq_len, device=self.device),
            tcfg.head_dim, tcfg.rope_theta)

    def handle(self, conn):
        raw = _recv_exact(conn, 4)
        if raw is None:
            return
        msg_len = struct.unpack("<I", raw)[0]
        if msg_len > MAX_TALKER_REQUEST:
            conn.sendall(struct.pack("<i", SENTINEL_ERROR))
            return
        body = _recv_exact(conn, msg_len)
        if body is None:
            return
        try:
            msg = json.loads(body.decode())
        except ValueError:
            conn.sendall(struct.pack("<i", SENTINEL_ERROR))
            return
        try:
            self._generate(conn, msg)
        except OSError:
            pass
        except Exception:
            try:
                conn.sendall(struct.pack("<i", SENTINEL_ERROR))
            except OSError:
                pass

    def _padded_ids(self, text: str):
        """The text's ids, padded to a bucket whose prefix fits the KV
        allocation; a longer text is truncated with a warning (the
        engine's rule)."""
        ids = self.tokenizer.encode(text, add_special_tokens=False)
        n = len(ids)
        limit = self.cfg.talker.max_seq_len - tk.PREFIX_EXTRA
        bucket = 16
        while bucket < n and bucket * 2 <= limit:
            bucket *= 2
        bucket = min(bucket, limit)
        if n > bucket:
            print(f"warning: text truncated to {bucket} of {n} tokens "
                  f"(max_seq_len={self.cfg.talker.max_seq_len})",
                  file=sys.stderr)
            n = bucket
        padded = np.zeros(bucket, np.int32)
        padded[:n] = ids[:n]
        return padded, n

    def _generate(self, conn, msg):
        tcfg = self.cfg.talker
        dev = self.device
        tp = self._tp
        padded, n = self._padded_ids(msg.get("text", ""))
        prefix, plen = tk.build_prefix(tp, torch.from_numpy(padded).to(dev),
                                       n)
        prefix = prefix.to(tp["codec_embedding"].dtype)
        kv = tfm.init_kv_cache(tfm.geometry_of(tcfg), 1, tcfg.max_seq_len,
                               dtype=prefix.dtype, device=dev)
        hidden, kv = tk.prefill(tp, prefix[None], plen[None], kv, tcfg)
        p0 = int(plen)
        pos = torch.tensor([p0], dtype=torch.int32, device=dev)
        ring = torch.full((1, self.cfg.sampling.repetition_window), -1,
                          dtype=torch.int32, device=dev)
        n_text = torch.tensor([n], dtype=torch.int32, device=dev)
        key = _urandom_key(dev)
        # a step writes K/V at pos: stop before the allocation's last row
        steps = min(self.cfg.max_tokens, tcfg.max_seq_len - 1 - p0)
        for i in range(steps):
            step = torch.tensor([i], dtype=torch.int32, device=dev)
            seeds = smp.token_seeds(key, step)[:, smp.SITE_CODE0]
            code0 = int(smp.sample_code0(tk.codec_logits(tp, hidden), ring,
                                         step, n_text, seeds,
                                         self.cfg.sampling)[0])
            if code0 == CODEC_EOS_ID or code0 >= NUM_AUDIO_CODES:
                break
            conn.sendall(struct.pack("<i", code0)
                         + hidden[0].float().cpu().numpy().tobytes())
            ring = smp.ring_push(ring, torch.tensor([code0], device=dev))
            fb = _recv_exact(conn, tcfg.hidden_size * 4)
            if fb is None:
                return
            feedback = torch.from_numpy(
                np.frombuffer(fb, np.float32).copy())[None].to(
                dev, hidden.dtype)
            hidden, kv = tk.decode_step(tp, feedback, pos, kv, tcfg,
                                        rope_table=self._rope)
            pos = pos + 1
        conn.sendall(struct.pack("<i", SENTINEL_DONE))


class CodePredictorCompatServer(_SocketServer):
    """The code predictor protocol: [hidden][code_0] -> 15 codes."""

    def __init__(self, params, cfg: TTSConfig,
                 socket_path: str = "/tmp/qwen3_cp.sock", device="cuda"):
        super().__init__(socket_path)
        self.cfg = cfg
        self.device = torch.device(device)
        self._codec_embedding = params["talker"]["codec_embedding"].to(
            self.device)
        self._cpp = cp.CodePredictor(cfg.code_predictor,
                                     params["code_predictor"]).to(
            self.device).weights()

    def handle(self, conn):
        H = self.cfg.talker.hidden_size
        hidden_data = _recv_exact(conn, H * 4)
        if hidden_data is None:
            return
        code_data = _recv_exact(conn, 4)
        if code_data is None:
            return
        code0 = struct.unpack("<i", code_data)[0]
        ce = self._codec_embedding
        hidden = torch.from_numpy(np.frombuffer(hidden_data, np.float32)
                                  .copy())[None].to(self.device, ce.dtype)
        c0e = ce[torch.tensor([code0], device=self.device)]
        seeds = smp.token_seeds(_urandom_key(self.device),
                                torch.zeros(1, device=self.device,
                                            dtype=torch.int32))
        codes = cp.predict_codes(self._cpp, hidden, c0e,
                                 seeds[:, smp.SITE_CP_GROUP1:],
                                 self.cfg.code_predictor, self.cfg.sampling)
        conn.sendall(codes[0, :15].to(torch.int32).cpu().numpy().tobytes())


class VocoderCompatServer(_SocketServer):
    """The vocoder protocol: [n][codes i64 n*16] -> [n_samples][i16...],
    rendered with the reference's crossfade (vocoder.synthesize_chunked)."""

    def __init__(self, params, cfg: TTSConfig,
                 socket_path: str = "/tmp/qwen3_voc.sock", device="cuda"):
        super().__init__(socket_path)
        self.cfg = cfg
        self.device = torch.device(device)
        self._vp = voc.Vocoder(cfg.vocoder, params["vocoder"]).to(
            self.device).weights()

    def handle(self, conn):
        header = _recv_exact(conn, 4)
        if header is None:
            return
        n_tokens = struct.unpack("<i", header)[0]
        if n_tokens <= 0 or n_tokens > MAX_VOCODER_TOKENS:
            return
        data = _recv_exact(conn, n_tokens * 16 * 8)
        if data is None:
            return
        codes = np.frombuffer(data, np.int64).reshape(n_tokens, 16)
        audio = voc.synthesize_chunked(
            lambda ch: voc.decode(self._vp, ch, self.cfg.vocoder),
            codes.astype(np.int32), VOC_CHUNK_SIZE, VOC_OVERLAP,
            device=self.device)
        audio_i16 = voc.to_int16(audio)
        conn.sendall(struct.pack("<i", len(audio_i16))
                     + audio_i16.tobytes())


def launch_all(params, cfg: TTSConfig, tokenizer,
               talker_sock="/tmp/qwen3_talker.sock",
               cp_sock="/tmp/qwen3_cp.sock",
               voc_sock="/tmp/qwen3_voc.sock", device="cuda"):
    """Start the three servers on daemon threads; returns (servers,
    threads). Call .stop() on each server to end it."""
    servers = [
        TalkerCompatServer(params, cfg, tokenizer, talker_sock, device),
        CodePredictorCompatServer(params, cfg, cp_sock, device),
        VocoderCompatServer(params, cfg, voc_sock, device),
    ]
    threads = []
    for s in servers:
        t = threading.Thread(target=s.serve, daemon=True)
        t.start()
        threads.append(t)
    return servers, threads
