"""Sentence segmentation for paragraph synthesis. Twin of
qwen3_tts_tpu/utils/text.py (a copy: the port imports nothing of the JAX
package).

One request is bounded by ``max_tokens`` codec tokens, and EOS pacing
expects ~3 codec tokens a text token, so one request covers a sentence,
not a paragraph. ``split_sentences`` and ``split_for_budget`` turn a
paragraph into sentence-sized pieces that
``TTSEngine.synthesize_long`` decodes in batched groups.
"""

from __future__ import annotations

import re
from typing import List

# sentence enders: ASCII + CJK full stops / question / exclamation,
# ellipsis; keep the delimiter attached to its sentence. Leading
# delimiter runs (an ellipsis pause cue) attach to the sentence that
# follows, and a delimiter-only residue is kept as its own piece —
# nothing the user wrote is silently dropped.
_D = r".!?。！？…"
_SENT_RE = re.compile(
    rf"[{_D}\s]*[^{_D}]+[{_D}]+[\"'»”’)]*"   # [...lead]body.delims"
    rf"|[{_D}\s]*[^{_D}]+$"                  # unterminated tail
    rf"|[{_D}\s]*[{_D}]+$")                  # delimiter-only residue


def split_sentences(text: str, max_chars: int = 0) -> List[str]:
    """Split ``text`` into sentences (delimiters kept). Newlines are
    hard boundaries. With ``max_chars`` > 0, any sentence longer than
    that is further split on comma/semicolon groups, then on whitespace,
    so every returned piece fits a bounded decode budget."""
    pieces: List[str] = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        for m in _SENT_RE.finditer(line):
            s = m.group(0).strip()
            if s:
                pieces.append(s)
    if max_chars and max_chars > 0:
        out: List[str] = []
        for s in pieces:
            out.extend(_bounded(s, max_chars))
        pieces = out
    return pieces


def piece_token_budget(cfg_max_tokens: int, max_tokens=None) -> int:
    """Per-piece ENCODED-token budget for paragraph synthesis, shared by
    every long-mode tier (engine.synthesize_long).
    EOS pacing forces a stop at 6*n_text+1 codec tokens (ops/sampling —
    3 expected codec tokens per text token, forced at 2x), so bounding a
    piece at (cap-1)//6 text tokens guarantees its decode is never
    truncated by the request cap."""
    cap = (min(int(max_tokens), cfg_max_tokens)
           if max_tokens is not None else cfg_max_tokens)
    return max(2, (cap - 1) // 6)


def split_for_budget(text: str, count_tokens, max_text_tokens: int,
                     merge: bool = True) -> List[str]:
    """Split ``text`` so each piece's ENCODED token count
    (``count_tokens``: str -> int, the production tokenizer) fits
    ``max_text_tokens``. Measuring in real tokens instead of chars fixes
    both failure modes of a char bound: BPE text (~0.3-0.5 tokens/char
    for Russian) is not over-split into prosody-breaking fragments, and
    multi-byte scripts under byte fallback (several tokens per CHAR)
    cannot blow past the decode budget and truncate mid-sentence.
    With ``merge`` (default), adjacent sentences re-pack greedily while
    the merged encoding stays within budget — fewer seams, fewer
    requests."""
    out: List[str] = []
    # merge greedily WITHIN a line only: newlines are hard prosodic
    # boundaries (split_sentences' contract) and must survive the merge:
    # list items and paragraph breaks without terminal punctuation stay
    # apart
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        pieces: List[str] = []
        for s in split_sentences(line):
            pieces.extend(_bounded_tokens(s, count_tokens, max_text_tokens))
        if not merge:
            out.extend(pieces)
            continue
        merged: List[str] = []
        for p in pieces:
            if merged:
                cand = merged[-1] + " " + p
                if count_tokens(cand) <= max_text_tokens:
                    merged[-1] = cand
                    continue
            merged.append(p)
        out.extend(merged)
    return out


def _bounded_tokens(s: str, count, budget: int) -> List[str]:
    if count(s) <= budget:
        return [s]
    for sep_re in (re.compile(r"(?<=[,;:、，；])\s*"), re.compile(r"\s+")):
        parts = [p for p in sep_re.split(s) if p]
        if len(parts) > 1:
            out: List[str] = []
            cur = ""
            for p in parts:
                cand = (cur + " " + p).strip() if cur else p
                if count(cand) <= budget:
                    cur = cand
                else:
                    if cur:
                        out.append(cur)
                    cur = p
            if cur:
                out.append(cur)
            return [q for p in out for q in _bounded_tokens(p, count, budget)]
    # no split point at all (one giant word): hard-cut at the largest
    # prefix that still encodes within budget (bisect on char length —
    # token count is monotone enough in prefix length for a cut point)
    out = []
    rest = s
    while rest:
        if count(rest) <= budget:
            out.append(rest)
            break
        lo, hi = 1, len(rest) - 1
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if count(rest[:mid]) <= budget:
                lo = mid
            else:
                hi = mid - 1
        out.append(rest[:lo])
        rest = rest[lo:]
    return out


def _bounded(s: str, max_chars: int) -> List[str]:
    """Char-budget split: exactly the token-budget algorithm with the
    counter fixed to ``len`` (one clause-split/greedy-pack implementation
    to maintain, not two)."""
    return _bounded_tokens(s, len, max_chars)
