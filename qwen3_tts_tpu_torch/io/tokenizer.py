"""Text tokenization for the port. Until checkpoint loading is ported
(which brings the checkpoint's own HF tokenizer), the port runs on
random weights and tokenizes with the byte fallback of
qwen3_tts_tpu/io/tokenizer.py: the UTF-8 bytes of the text as token
ids, which gives the prefix and the EOS pacing their real shapes."""

from __future__ import annotations

from typing import List


class ByteFallbackTokenizer:
    """Deterministic stand-in: UTF-8 bytes as token ids (0..255)."""

    name = "byte-fallback"

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        del add_special_tokens
        return list(text.encode("utf-8"))
