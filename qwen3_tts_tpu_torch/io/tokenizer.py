"""Text tokenization for the port, as qwen3_tts_tpu/io/tokenizer.py does
it: the checkpoint's HF tokenizer (``transformers.AutoTokenizer``, local
files only, imported when a tokenizer is loaded), else the cached
Qwen3-TTS tokenizer, else a byte fallback: the UTF-8 bytes of the text
as token ids, which gives the prefix and the EOS pacing their real
shapes but not the real model's token counts. Falling back despite a
``model_dir`` is said on stderr."""

from __future__ import annotations

import os
import sys
from typing import List, Optional


class ByteFallbackTokenizer:
    """Deterministic stand-in: UTF-8 bytes as token ids (0..255)."""

    name = "byte-fallback"

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        del add_special_tokens
        return list(text.encode("utf-8"))


def load_tokenizer(model_dir: Optional[str] = None):
    """The HF tokenizer of ``model_dir`` (local files only), else the
    cached Qwen3-TTS tokenizer, else ByteFallbackTokenizer (a dev mode:
    EOS pacing, expected_len = 3 x n_text_tokens, behaves otherwise under
    ~1 token a byte than under BPE). ``QWEN3_TTS_TOKENIZER=byte`` forces
    the fallback. Where ``transformers`` is not installed, every
    checkpoint falls back, with the warning."""
    if os.environ.get("QWEN3_TTS_TOKENIZER") == "byte":
        return ByteFallbackTokenizer()
    if model_dir is not None:
        try:
            from transformers import AutoTokenizer
            return AutoTokenizer.from_pretrained(
                model_dir, trust_remote_code=True, local_files_only=True)
        except Exception as e:  # noqa: BLE001 - any failure falls back
            print(f"warning: no tokenizer loadable from {model_dir} ({e}); "
                  "trying the cached Qwen3-TTS tokenizer", file=sys.stderr)
    try:
        from transformers import AutoTokenizer
        return AutoTokenizer.from_pretrained(
            "Qwen/Qwen3-TTS-12Hz-0.6B-Base", trust_remote_code=True,
            local_files_only=True)
    except Exception:  # noqa: BLE001 - any failure falls back
        if model_dir is not None:
            print("warning: falling back to the BYTE tokenizer (dev mode): "
                  "token counts and EOS pacing will not match the real "
                  "model's BPE", file=sys.stderr)
        return ByteFallbackTokenizer()
