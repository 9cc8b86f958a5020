"""TTSEngine: synthesis, text -> codes -> 24 kHz int16 audio, one
request (``synthesize``, whole or streamed) or several in one batched
decode (``synthesize_batch``). Twin of qwen3_tts_tpu/engine/engine.py.

tokenize -> dual-stream prefix -> talker prefill -> decode loop
(engine/generate.py) -> FP32 vocoder -> optional WAV. Non-streaming
requests vocode through ``vocoder.synthesize_exact``: one window of
voc_bucket(n + 1) tokens up to 256 tokens, left-context chunks past
that. ``streaming=True`` decodes the head in chunks of 8 and 56 tokens,
then the rest in one call, and hands each piece of audio to
``on_chunk`` as soon as it is final, through the incremental vocoder
stream (models/vocoder_stream: O(new tokens) an emission, within +-1
LSB of the non-streaming audio).
``SynthesisResult.first_audio_seconds`` is the wall time until the first
samples reach the host. With ``quantize="int8"`` (or int8 trees in
``params``) the decode loop runs the hand-written kernels K1 (int8
products), K2 (code predictor steps) and K3 (talker decode step, up to 8
rows); with ``TalkerConfig(attention_impl="pallas")`` a per-layer talker
step's attention runs on K5.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from qwen3_tts_tpu_torch.config import (
    SAMPLE_RATE,
    SUPPORTED_LANGUAGES,
    SamplingConfig,
    TTSConfig,
)
from qwen3_tts_tpu_torch.engine import generate as gen
from qwen3_tts_tpu_torch.io import wav as wav_io
from qwen3_tts_tpu_torch.io import weights as weights_io
from qwen3_tts_tpu_torch.io.tokenizer import ByteFallbackTokenizer
from qwen3_tts_tpu_torch.models import talker as tk
from qwen3_tts_tpu_torch.models import vocoder as voc
from qwen3_tts_tpu_torch.models import vocoder_stream as vstream
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
    # wall seconds from the call until the first samples reached the
    # host; None when no token was generated
    first_audio_seconds: Optional[float] = None

    @property
    def audio_seconds(self) -> float:
        return len(self.audio_int16) / SAMPLE_RATE


_TEXT_BUCKETS = (16, 32, 64, 128, 256)


def _bucket(n: int) -> int:
    for b in _TEXT_BUCKETS:
        if n <= b:
            return b
    return _TEXT_BUCKETS[-1]


def _pacing_bound(budget_cap: int, n_text: int,
                  scfg: SamplingConfig) -> int:
    """Tightest known bound on generated tokens. For n_text > 0 the
    EOS-pacing force (progress > eos_force_progress, ops/sampling.py)
    gives n <= expected_tokens_per_text_token * eos_force_progress *
    n_text + 1; n_text == 0 disables pacing, so only the budget bounds
    the decode."""
    if n_text <= 0:
        return budget_cap
    mult = scfg.expected_tokens_per_text_token * scfg.eos_force_progress
    return min(budget_cap, int(math.ceil(mult * n_text)) + 2)


def vocode(vp: Dict, codes: np.ndarray, cfg, device) -> np.ndarray:
    """codes (n, 16) -> int16 audio (n * 1920,) through the vocoder
    weights vp: voc.synthesize_exact (one window of voc_bucket(n + 1)
    tokens up to 256, so the last token has a zero-code lookahead token;
    left-context chunks past that), converted to int16 on the device."""
    return voc.to_int16(voc.synthesize_exact(voc.int16_decoder(vp, cfg),
                                             codes, device=device))


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
    in the port's layout (io/weights.py) instead. A talker or code
    predictor in ``params`` that is already int8 (quant.quantize_talker,
    quantize_code_predictor) is kept as it is; ``quantize="int8"``
    quantizes the halves that are still dense, and ``self.quantize``
    reports the state: "int8", "int8-cp" (only the code predictor) or
    "int8-talker" (only the talker)."""

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
        pre_t = quant.is_quantized(params["talker"])
        pre_c = quant.is_quantized(params["code_predictor"])
        if pre_t or pre_c:
            # never quantize twice; quantize="int8" fills in a dense half
            if quantize == "int8":
                if not pre_t:
                    params["talker"] = quant.quantize_talker(
                        params["talker"])
                if not pre_c:
                    params["code_predictor"] = \
                        quant.quantize_code_predictor(params["code_predictor"])
                pre_t = pre_c = True
            quantize = ("int8" if pre_t and pre_c
                        else "int8-cp" if pre_c else "int8-talker")
        elif quantize == "int8":
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
        # streaming: first audio after 8 tokens, one more chunk of 56 to
        # bank playout headroom, then the rest in one run_steps call
        self.head_schedule = (8, 56)
        self._stream_stepper = vstream.StreamStepper(c.vocoder)

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
        """codes (n, 16) -> int16 audio (n * 1920,) through
        voc.synthesize_exact (see the module function ``vocode``)."""
        return vocode(self._vp, codes, self.cfg.vocoder, self.device)

    def _prefill(self, text_ids, n_text: int, seed: int,
                 budget_cap: int) -> gen.GenState:
        """Prefix, talker prefill and the loop state of one request."""
        prefix, plen = tk.build_prefix(self._tp, text_ids, n_text)
        n_text_t = torch.tensor([n_text], dtype=torch.int32,
                                device=self.device)
        return gen.init_state(self._tp, prefix[None], plen[None], n_text_t,
                              smp.batch_keys(seed, 1), self.cfg,
                              budget=budget_cap)

    def _run(self, state: gen.GenState, steps: int) -> gen.GenState:
        return gen.run_steps(self._tp, self._cpp, state, self.cfg, steps)

    @staticmethod
    def _status(state: gen.GenState) -> tuple:
        """(done, n_codes) of row 0, in one device read."""
        st = torch.stack([state.done[:1].to(torch.int32),
                          state.n_codes[:1]]).cpu()
        return bool(st[0, 0]), int(st[1, 0])

    @torch.inference_mode()
    def synthesize(self, text: str, language: str = "russian",
                   output: Optional[str] = None, streaming: bool = False,
                   seed: int = 0, prompt_dir: Optional[str] = None,
                   max_tokens: Optional[int] = None,
                   on_chunk=None) -> SynthesisResult:
        """Full pipeline: text -> codes -> audio. ``language`` is
        validated but, as in the reference, does not change the prefix.
        ``max_tokens`` caps this request's tokens. ``on_chunk`` (with
        ``streaming=True``) is called with each np.int16 piece of audio as
        soon as it is final; the pieces concatenate to ``audio_int16``.
        Codes do not depend on ``streaming``."""
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
        if not streaming:
            with _stage(timings, "decode"):
                state = self._run(self._prefill(text_ids, n_text, seed,
                                                budget), budget)
                n = int(state.n_codes[0])
                codes = state.codes[0, :n].cpu().numpy()
            with _stage(timings, "vocoder"):
                audio = self.vocode(codes)
            first = time.perf_counter() - t_start
        else:
            with _stage(timings, "prefill"):
                # the first head chunk runs with the prefill
                head = min(self.head_schedule[0], budget)
                state = self._run(self._prefill(text_ids, n_text, seed,
                                                budget), head)
            with _stage(timings, "decode+vocoder"):
                audio, n, codes, first = self._stream(state, budget, n_text,
                                                      on_chunk, t_start)
        audio = voc.to_int16(audio)
        if output:
            wav_io.write_wav(output, audio)
        total = time.perf_counter() - t_start
        seconds = len(audio) / SAMPLE_RATE
        return SynthesisResult(
            audio_int16=audio, codes=codes, n_tokens=n,
            timings=timings, total_seconds=total,
            rtf=total / seconds if seconds > 0 else float("inf"),
            first_audio_seconds=first if n > 0 else None)

    def _stream(self, state, budget: int, n_text: int, on_chunk,
                t_start: float):
        """Streaming on models/vocoder_stream: after each head chunk the
        stream is advanced over the chunk's new final frames in
        StreamStepper quanta, O(new tokens) wherever it sits; after the
        last decode call the steps up to the EOS-pacing bound, plus the
        zero-code frame that flushes the stream's lag of output_crop
        samples, are launched before the token count is read, and trimmed
        to it. The kept samples equal the non-streaming decode within the
        stream contract (+-1 LSB). The stream's position is a host int.
        Returns (int16 audio, n, codes, first-audio seconds)."""
        stepper = self._stream_stepper
        stream = vstream.Stream()
        pending: List[vstream.Segment] = []
        chunks: List[np.ndarray] = []
        decoded = flushed = 0
        first = None

        def advance(end: int, final: bool) -> None:
            pending.extend(stepper.advance(self._vp, state.codes[0], stream,
                                           end, final))

        def flush(n_known: int) -> None:
            """Fetch the launched steps in order, trimming each to the
            known token count, and hand each piece to on_chunk."""
            nonlocal flushed, first
            while flushed < len(pending):
                a = pending[flushed].take(n_known)
                flushed += 1
                if not len(a):
                    continue
                chunks.append(a)
                if first is None:
                    first = time.perf_counter() - t_start
                if on_chunk is not None:
                    on_chunk(a)

        done = False
        for ci, step_budget in enumerate(self.head_schedule):
            step_budget = min(step_budget, budget - decoded)
            if step_budget <= 0:
                break
            if ci > 0:
                state = self._run(state, step_budget)
            decoded += step_budget
            if on_chunk is None:
                # no consumer: no status read; frames past an EOS inside
                # the chunk are zeros, trimmed by the last flush
                advance(decoded, False)
                if first is None and pending:
                    pending[0].fetch()
                    first = time.perf_counter() - t_start
                continue
            done, n_now = self._status(state)
            end = n_now if done else decoded
            advance(end, done)
            flush(end)
            if done:
                break
        if not done:
            if decoded < budget:
                state = self._run(state, budget - decoded)
            # every possibly final frame, launched before the token count
            # is read; the overshoot is trimmed
            advance(min(_pacing_bound(budget, n_text, self.cfg.sampling),
                        int(state.codes.shape[1])), True)
        n = int(state.n_codes[0])
        codes = state.codes[0, :n].cpu().numpy()
        advance(n, True)       # launches nothing unless n passed the bound
        flush(n)
        audio = (np.concatenate(chunks) if chunks
                 else np.zeros((0,), np.int16))
        return audio, n, codes, first

    @torch.inference_mode()
    def synthesize_batch(self, texts, languages=None, seed: int = 0,
                         max_tokens: Optional[int] = None):
        """Several texts in ONE batched decode: every text is padded to
        the largest bucket, one batched prefix and prefill, one batched
        loop, then each row is vocoded through voc.synthesize_exact. Row
        i draws with key batch_keys(seed, B)[i] (row 0 as
        synthesize(seed=seed)).
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
                rows.append((codes, self.vocode(codes)))
        total = time.perf_counter() - t_start
        results = []
        for codes, audio in rows:
            dur = len(audio) / SAMPLE_RATE
            results.append(SynthesisResult(
                audio_int16=audio, codes=codes, n_tokens=len(codes),
                timings=dict(timings), total_seconds=total,
                rtf=total / dur if dur > 0 else float("inf")))
        return results
