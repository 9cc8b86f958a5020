"""Named voice registry for the serving tiers. Twin of
qwen3_tts_tpu/serve/voices.py (framework-free; a copy, since the port
imports nothing of the JAX package).

A voice is a prompt dir (``ref_codec_tokens.npy`` and an optional
``ref_text.txt``, as tools/encode_reference_audio.py writes them).
``VoiceRegistry(root)`` scans ``root`` once: every subdirectory holding
``ref_codec_tokens.npy`` becomes a voice named after the subdirectory.
``resolve(name)`` maps a registered name to its prompt dir; the daemon
applies it to a request's ``"voice"`` field on both transports and both
tiers, and ``GET /v1/audio/voices`` (serve/http.py) lists the names. Raw
prompt_dir paths stay accepted where they were (the ``prompt_dir``
field, and the OpenAI route's ``voice`` fallback).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional


def is_prompt_dir(path: str) -> bool:
    """A usable voice-cloning prompt_dir: a directory holding the codec
    tokens file tools/encode_reference_audio.py writes. Content errors
    (corrupt npy) surface later through engine._load_prompt's
    self-identifying ValueError."""
    return (os.path.isdir(path)
            and os.path.exists(os.path.join(path, "ref_codec_tokens.npy")))


class VoiceRegistry:
    """Immutable-after-construction map of voice name -> prompt_dir.

    Names are the subdirectory basenames under ``root`` (sorted,
    deterministic). "default" is reserved for the unconditioned model
    voice and is rejected as a registration name.
    """

    RESERVED = ("default", "")

    def __init__(self, root: Optional[str] = None):
        self._voices: Dict[str, str] = {}
        if root is not None:
            if not os.path.isdir(root):
                raise ValueError(f"voices root {root!r} is not a directory")
            for name in sorted(os.listdir(root)):
                path = os.path.join(root, name)
                if is_prompt_dir(path):
                    self.register(name, path)

    def register(self, name: str, prompt_dir: str) -> None:
        if not isinstance(name, str) or name in self.RESERVED:
            raise ValueError(f"invalid voice name {name!r}")
        if not is_prompt_dir(prompt_dir):
            raise ValueError(
                f"voice {name!r}: {prompt_dir!r} is not a prompt_dir "
                "(expected a directory with ref_codec_tokens.npy, as "
                "written by tools/encode_reference_audio.py)")
        self._voices[name] = prompt_dir

    def resolve(self, name: str) -> Optional[str]:
        """prompt_dir for a registered name, else None (callers decide
        whether to fall back to treating ``name`` as a raw path)."""
        return self._voices.get(name)

    def names(self) -> List[str]:
        """Registered voice names, sorted ("default" not included — it
        is the absence of a prompt, listed separately by the API)."""
        return sorted(self._voices)

    def __len__(self) -> int:
        return len(self._voices)
