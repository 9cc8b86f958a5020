"""WAV output: mono 16-bit PCM, as qwen3_tts_tpu/io/wav.py writes it."""

from __future__ import annotations

import wave

import numpy as np

from qwen3_tts_tpu_torch.config import SAMPLE_RATE


def write_wav(path: str, audio_int16: np.ndarray,
              sample_rate: int = SAMPLE_RATE) -> None:
    with wave.open(path, "w") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(sample_rate)
        wf.writeframes(np.ascontiguousarray(audio_int16, np.int16).tobytes())
