"""TTSEngine: synthesis, text -> codes -> 24 kHz int16 audio, one
request (``synthesize``) or several in one batched decode
(``synthesize_batch``). Twin of the non-streaming paths of
qwen3_tts_tpu/engine/engine.py.

tokenize -> dual-stream prefix -> talker prefill -> decode loop
(engine/generate.py) -> FP32 vocoder over a bucketed window with at
least one zero-code lookahead token -> crop to n_tokens * 1920 samples
-> optional WAV. With ``quantize="int8"`` the decode loop runs the three
hand-written kernels: K1 (int8 products), K2 (code predictor steps) and
K3 (talker decode step, up to 8 rows). With ``TalkerConfig(
attention_impl="pallas")`` a per-layer talker step's attention runs on
K5.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from qwen3_tts_tpu_torch.config import (
    SAMPLE_RATE,
    SAMPLES_PER_TOKEN,
    SUPPORTED_LANGUAGES,
    TTSConfig,
)
from qwen3_tts_tpu_torch.engine import generate as gen
from qwen3_tts_tpu_torch.io import wav as wav_io
from qwen3_tts_tpu_torch.io import weights as weights_io
from qwen3_tts_tpu_torch.io.tokenizer import ByteFallbackTokenizer
from qwen3_tts_tpu_torch.models import talker as tk
from qwen3_tts_tpu_torch.models import vocoder as voc
from qwen3_tts_tpu_torch.models.code_predictor import CodePredictor
from qwen3_tts_tpu_torch.ops import quant
from qwen3_tts_tpu_torch.ops import sampling as smp


@dataclasses.dataclass
class SynthesisResult:
    audio_int16: np.ndarray           # mono 24 kHz
    codes: np.ndarray                 # (n_tokens, 16)
    n_tokens: int
    timings: Dict[str, float]
    total_seconds: float
    rtf: float

    @property
    def audio_seconds(self) -> float:
        return len(self.audio_int16) / SAMPLE_RATE


_TEXT_BUCKETS = (16, 32, 64, 128, 256)


def _bucket(n: int) -> int:
    for b in _TEXT_BUCKETS:
        if n <= b:
            return b
    return _TEXT_BUCKETS[-1]


def vocode(vp: Dict, codes: np.ndarray, cfg, device) -> np.ndarray:
    """codes (n, 16) -> f32 audio (n * 1920,) through the vocoder weights
    vp: one window of voc_bucket(n + 1) tokens, so the last token always
    has a zero-code lookahead token, cropped to n tokens."""
    n = len(codes)
    if n == 0:
        return np.zeros((0,), np.float32)
    W = voc.voc_bucket(n + 1)
    buf = torch.zeros((1, W, 16), dtype=torch.int32)
    buf[0, :n] = torch.from_numpy(np.asarray(codes[:, :16], np.int32))
    audio = voc.decode(vp, buf.to(device), cfg)
    return audio[0, :n * SAMPLES_PER_TOKEN].cpu().numpy()


def check_one_window(n: int) -> None:
    """The batched tiers vocode one window of at most 256 tokens, as the
    JAX package does; it renders longer utterances with the chunked
    synthesize_exact, which is not ported yet."""
    if n > 256:
        raise NotImplementedError(
            f"{n} tokens exceed one vocoder window (256): the chunked "
            "exact vocoder is not ported yet (ROADMAP queue 1: "
            "synthesize_exact, with the streaming slice)")


@contextlib.contextmanager
def _stage(timings: Dict[str, float], name: str):
    """Adds the wall seconds of the block to timings[name]."""
    t = time.perf_counter()
    try:
        yield
    finally:
        timings[name] = timings.get(name, 0.0) + time.perf_counter() - t


class TTSEngine:
    """Single-request TTS engine on one device. ``model_dir=None`` runs
    with random weights drawn from ``seed``; ``params`` supplies weights
    in the port's layout (io/weights.py) instead."""

    def __init__(self, cfg: Optional[TTSConfig] = None,
                 model_dir: Optional[str] = None,
                 dtype=torch.bfloat16, seed: int = 0,
                 params: Optional[Dict] = None,
                 quantize: Optional[str] = None,
                 device="cuda"):
        if model_dir is not None:
            raise NotImplementedError(
                "checkpoint loading is not ported yet (ROADMAP: HF "
                "safetensors loading); pass params= or model_dir=None")
        if quantize not in (None, "int8"):
            raise ValueError(f"unsupported quantize={quantize!r}")
        self.cfg = cfg or TTSConfig()
        self.device = torch.device(device)
        params = (dict(params) if params is not None else
                  weights_io.init_random_params(self.cfg, seed, dtype,
                                               self.device))
        if quantize == "int8":
            params["talker"] = quant.quantize_talker(params["talker"])
            params["code_predictor"] = quant.quantize_code_predictor(
                params["code_predictor"])
        self.quantize = quantize
        c = self.cfg
        self.talker = tk.Talker(c.talker, params["talker"]).to(self.device)
        self.code_predictor = CodePredictor(
            c.code_predictor, params["code_predictor"]).to(self.device)
        self.vocoder = voc.Vocoder(c.vocoder,
                                   params["vocoder"]).to(self.device)
        self._tp = self.talker.weights()
        self._cpp = self.code_predictor.weights()
        self._vp = self.vocoder.weights()
        self.tokenizer = ByteFallbackTokenizer()

    def _encode_text(self, text: str):
        """Token ids padded to a bucket that fits the KV allocation; text
        past it is truncated with a warning. Returns (ids, n)."""
        ids = self.tokenizer.encode(text, add_special_tokens=False)
        limit = self.cfg.talker.max_seq_len - tk.PREFIX_EXTRA
        b = _bucket(len(ids))
        if b > limit:
            fits = [bk for bk in _TEXT_BUCKETS if bk <= limit]
            b = fits[-1] if fits else max(limit, 1)
        if len(ids) > b:
            print(f"warning: text truncated to {b} of {len(ids)} tokens "
                  f"(max_seq_len={self.cfg.talker.max_seq_len})",
                  file=sys.stderr)
        padded = torch.zeros((b,), dtype=torch.int32)
        n = min(len(ids), b)
        padded[:n] = torch.tensor(ids[:n], dtype=torch.int32)
        return padded.to(self.device), n

    def vocode(self, codes: np.ndarray) -> np.ndarray:
        """codes (n, 16) -> f32 audio (n * 1920,): one window of
        voc_bucket(n + 1) tokens, so the last token always has a
        zero-code lookahead token, cropped to n tokens."""
        return vocode(self._vp, codes, self.cfg.vocoder, self.device)

    @torch.inference_mode()
    def synthesize(self, text: str, language: str = "russian",
                   output: Optional[str] = None, streaming: bool = False,
                   seed: int = 0, prompt_dir: Optional[str] = None,
                   max_tokens: Optional[int] = None) -> SynthesisResult:
        """Full pipeline: text -> codes -> audio, non-streaming.
        ``language`` is validated but, as in the reference, does not
        change the prefix. ``max_tokens`` caps this request's tokens."""
        if streaming:
            raise NotImplementedError(
                "streaming synthesis is not ported yet (ROADMAP queue 1: "
                "streaming window path and vocoder_stream)")
        if prompt_dir is not None:
            raise NotImplementedError(
                "voice cloning (prompt_dir) is not ported yet (ROADMAP "
                "queue 1: voice cloning and the encoder)")
        if language not in SUPPORTED_LANGUAGES:
            raise ValueError(f"unsupported language {language!r}; expected "
                             f"one of {SUPPORTED_LANGUAGES}")
        budget = self.cfg.max_tokens
        if max_tokens is not None:
            if max_tokens < 1:
                raise ValueError(f"max_tokens must be >= 1, got {max_tokens}")
            budget = min(int(max_tokens), budget)

        timings: Dict[str, float] = {}
        t_start = time.perf_counter()
        with _stage(timings, "tokenize"):
            text_ids, n_text = self._encode_text(text)
        with _stage(timings, "decode"):
            prefix, plen = tk.build_prefix(self._tp, text_ids, n_text)
            n_text_t = torch.tensor([n_text], dtype=torch.int32,
                                    device=self.device)
            state = gen.init_state(self._tp, prefix[None], plen[None],
                                   n_text_t, smp.batch_keys(seed, 1),
                                   self.cfg, budget=budget)
            state = gen.run_steps(self._tp, self._cpp, state, self.cfg,
                                  budget)
            n = int(state.n_codes[0])
            codes = state.codes[0, :n].cpu().numpy()
        with _stage(timings, "vocoder"):
            check_one_window(len(codes))
            audio = voc.to_int16(self.vocode(codes))
        if output:
            wav_io.write_wav(output, audio)
        total = time.perf_counter() - t_start
        seconds = len(audio) / SAMPLE_RATE
        return SynthesisResult(
            audio_int16=audio, codes=codes, n_tokens=n,
            timings=timings, total_seconds=total,
            rtf=total / seconds if seconds > 0 else float("inf"))

    @torch.inference_mode()
    def synthesize_batch(self, texts, languages=None, seed: int = 0,
                         max_tokens: Optional[int] = None):
        """Several texts in ONE batched decode: every text is padded to
        the largest bucket, one batched prefix and prefill, one batched
        loop, then each row is vocoded at voc_bucket(n + 1). Row i draws
        with key batch_keys(seed, B)[i] (row 0 as synthesize(seed=seed)).
        ``max_tokens`` caps every row. Returns one SynthesisResult per
        text, sharing the timing fields."""
        if not len(texts):
            return []
        languages = languages or ["russian"] * len(texts)
        for lang in languages:
            if lang not in SUPPORTED_LANGUAGES:
                raise ValueError(f"unsupported language {lang!r}")
        if max_tokens is not None and max_tokens < 1:
            raise ValueError(f"max_tokens must be >= 1, got {max_tokens}")
        budget = (min(int(max_tokens), self.cfg.max_tokens)
                  if max_tokens is not None else self.cfg.max_tokens)
        B = len(texts)
        timings: Dict[str, float] = {}
        t_start = time.perf_counter()
        with _stage(timings, "tokenize"):
            encoded = [self._encode_text(t) for t in texts]
            bucket = max(int(ids.shape[0]) for ids, _ in encoded)
            ids = torch.zeros((B, bucket), dtype=torch.int32,
                              device=self.device)
            for i, (row, _) in enumerate(encoded):
                ids[i, :row.shape[0]] = row
            n_text = torch.tensor([n for _, n in encoded], dtype=torch.int32,
                                  device=self.device)
        with _stage(timings, "decode"):
            prefixes = [tk.build_prefix(self._tp, ids[i], encoded[i][1])
                        for i in range(B)]
            prefix = torch.stack([p for p, _ in prefixes])
            plen = torch.stack([n for _, n in prefixes])
            state = gen.init_state(self._tp, prefix, plen, n_text,
                                   smp.batch_keys(seed, B), self.cfg,
                                   budget=budget)
            state = gen.run_steps(self._tp, self._cpp, state, self.cfg,
                                  budget)
            n_codes = state.n_codes.cpu().numpy()
            codes_all = state.codes.cpu().numpy()
        rows = []
        with _stage(timings, "vocoder"):
            for i in range(B):
                codes = codes_all[i, :int(n_codes[i])]
                check_one_window(len(codes))
                rows.append((codes, voc.to_int16(self.vocode(codes))))
        total = time.perf_counter() - t_start
        results = []
        for codes, audio in rows:
            dur = len(audio) / SAMPLE_RATE
            results.append(SynthesisResult(
                audio_int16=audio, codes=codes, n_tokens=len(codes),
                timings=dict(timings), total_seconds=total,
                rtf=total / dur if dur > 0 else float("inf")))
        return results
