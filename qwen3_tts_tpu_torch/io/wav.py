"""WAV files: mono 16-bit PCM out, 16- or 32-bit PCM in, as
qwen3_tts_tpu/io/wav.py reads and writes them."""

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


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Returns (float32 mono waveform in [-1, 1], sample_rate); channels
    are averaged."""
    with wave.open(path, "r") as wf:
        sr = wf.getframerate()
        n = wf.getnframes()
        ch = wf.getnchannels()
        width = wf.getsampwidth()
        raw = wf.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if ch > 1:
        data = data.reshape(-1, ch).mean(axis=1)
    return data, sr
