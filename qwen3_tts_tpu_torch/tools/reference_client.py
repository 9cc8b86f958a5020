"""Socket client of the reference-protocol compatibility stack
(serve/compat.py). Twin of tools/reference_client.py.

Streams (code_0, hidden) from the talker socket, fetches groups 1..15
from the code predictor socket per token, sums the feedback embedding on
the host (codec_embedding[code_0] + sum_g cp codec_embs[g][code_g] +
tts_pad, from the port's talker and code predictor weights), and renders
the audio through the vocoder socket.

    python -m qwen3_tts_tpu_torch.tools.launch_compat_stack "text"

runs it against a stack of its own.
"""

from __future__ import annotations

import json
import socket
import struct
import time

import numpy as np
import torch

from qwen3_tts_tpu_torch.config import SAMPLE_RATE, TTS_PAD_TOKEN_ID
from qwen3_tts_tpu_torch.io import wav as wav_io
from qwen3_tts_tpu_torch.models import talker as tk
from qwen3_tts_tpu_torch.serve.compat import SENTINEL_DONE, SENTINEL_ERROR
from qwen3_tts_tpu_torch.serve.daemon import _recv_exact


def _host_f32(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def feedback_tables(params) -> tuple:
    """(codec_embedding (V, H), cp codec_embs (15, G, H), tts_pad (H,))
    as f32 host arrays from the port's weight trees."""
    tp, cpp = params["talker"], params["code_predictor"]
    with torch.inference_mode():
        pad = tk.embed_text(tp, torch.tensor([TTS_PAD_TOKEN_ID],
                                             device=tp["codec_embedding"]
                                             .device))[0]
    return (_host_f32(tp["codec_embedding"]), _host_f32(cpp["codec_embs"]),
            _host_f32(pad))


def reference_flow(text: str, language: str, params,
                   talker_sock="/tmp/qwen3_talker.sock",
                   cp_sock="/tmp/qwen3_cp.sock",
                   voc_sock="/tmp/qwen3_voc.sock", log=print) -> tuple:
    """The reference client's loop over the three sockets. Returns
    (codes (n, 16) int64, int16 audio); raises RuntimeError when a server
    sends the error sentinel or closes mid-reply."""
    codec_emb, cp_embs, tts_pad = feedback_tables(params)
    H = codec_emb.shape[1]
    t_start = time.time()
    all_codes = []
    tc = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        tc.connect(talker_sock)
        msg = json.dumps({"text": text, "language": language}).encode()
        tc.sendall(struct.pack("<I", len(msg)) + msg)
        while True:
            raw = _recv_exact(tc, 4)
            if raw is None:
                break
            code0 = struct.unpack("<i", raw)[0]
            if code0 == SENTINEL_DONE:
                break
            if code0 == SENTINEL_ERROR:
                raise RuntimeError("talker error sentinel")
            hdat = _recv_exact(tc, H * 4)
            if hdat is None:
                raise RuntimeError("talker closed mid-stream")
            hidden = np.frombuffer(hdat, np.float32)
            cc = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            try:
                cc.connect(cp_sock)
                cc.sendall(hidden.tobytes() + struct.pack("<i", code0))
                cdat = _recv_exact(cc, 60)
            finally:
                cc.close()
            if cdat is None:
                raise RuntimeError("code predictor closed mid-reply")
            codes_1_15 = np.frombuffer(cdat, np.int32)
            all_codes.append([code0] + codes_1_15.tolist())
            feedback = codec_emb[code0].copy()
            for g, tok in enumerate(codes_1_15):
                feedback += cp_embs[g][tok]
            feedback += tts_pad
            tc.sendall(feedback.astype(np.float32).tobytes())
            if len(all_codes) % 10 == 0:
                el = time.time() - t_start
                log(f"  [{len(all_codes)}] {len(all_codes) / el:.1f} tok/s")
    finally:
        tc.close()
    codes = np.array(all_codes, np.int64).reshape(-1, 16)
    if not len(codes):
        return codes, np.zeros(0, np.int16)
    vc = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        vc.connect(voc_sock)
        vc.sendall(struct.pack("<i", len(codes)) + codes.tobytes())
        vhdr = _recv_exact(vc, 4)
        if vhdr is None:
            raise RuntimeError("vocoder closed before its reply")
        n_samples = struct.unpack("<i", vhdr)[0]
        adat = _recv_exact(vc, n_samples * 2)
        if adat is None:
            raise RuntimeError("vocoder closed mid-reply")
    finally:
        vc.close()
    return codes, np.frombuffer(adat, np.int16)


def synthesize_via_sockets(text, language, output, params,
                           talker_sock="/tmp/qwen3_talker.sock",
                           cp_sock="/tmp/qwen3_cp.sock",
                           voc_sock="/tmp/qwen3_voc.sock") -> int:
    """reference_flow, then the WAV at ``output``; returns an exit code
    (1 on a protocol error or no tokens)."""
    t_start = time.time()
    try:
        codes, audio = reference_flow(text, language, params, talker_sock,
                                      cp_sock, voc_sock)
    except RuntimeError as e:
        print(f"error: {e}")
        return 1
    if not len(codes):
        print("No tokens generated!")
        return 1
    wav_io.write_wav(output, audio)
    dur = len(audio) / SAMPLE_RATE
    total = time.time() - t_start
    print(f"Audio: {dur:.2f}s, saved to {output}")
    print(f"Total: {total:.1f}s (RTF={total / dur:.1f}x)")
    return 0
