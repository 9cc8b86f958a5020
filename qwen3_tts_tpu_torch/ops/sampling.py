"""Sampling policies. Twin of qwen3_tts_tpu/ops/sampling.py, batched over
a leading row axis.

code_0 policy: mask to audio codes + EOS, adaptive EOS boost, repetition
penalty over a 30-token window, then top-k -> temperature softmax ->
top-p nucleus cut -> categorical. CP group policy: top-k + temperature.

The deterministic transforms (mask, boost, penalty, ring) are bit-equal
to JAX. Draws come from an explicit ``torch.Generator``; they cannot
reproduce ``jax.random`` bits. Temperature 0 means argmax (first index).
"""

from __future__ import annotations

from typing import Tuple

import torch

from qwen3_tts_tpu_torch.config import (
    CODEC_EOS_ID,
    NUM_AUDIO_CODES,
    SamplingConfig,
)

NEG = -1e10


def mask_code0_logits(logits: torch.Tensor) -> torch.Tensor:
    """Allow audio codes 0..2047 and EOS; logits (..., codec_vocab)."""
    idx = torch.arange(logits.shape[-1], device=logits.device)
    allowed = (idx < NUM_AUDIO_CODES) | (idx == CODEC_EOS_ID)
    return torch.where(allowed, logits, torch.full_like(logits, NEG))


def eos_boost(logits: torch.Tensor, step: torch.Tensor,
              n_text_tokens: torch.Tensor,
              cfg: SamplingConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Adaptive EOS boost. logits (B, V); step, n_text_tokens (B,).
    Returns (boosted logits, force_eos (B,) bool)."""
    expected = (n_text_tokens * cfg.expected_tokens_per_text_token).float()
    safe = torch.where(expected > 0, expected, torch.ones_like(expected))
    progress = torch.where(expected > 0, step.float() / safe,
                           torch.zeros_like(expected))
    ramp = torch.clamp((progress - cfg.eos_boost_start) / cfg.eos_boost_ramp,
                       max=1.0) * cfg.eos_boost_max
    boost = torch.where(progress > cfg.eos_boost_start, ramp,
                        torch.zeros_like(ramp))
    logits = logits.clone()
    logits[..., CODEC_EOS_ID] += boost
    return logits, progress > cfg.eos_force_progress


def repetition_penalty(logits: torch.Tensor, ring: torch.Tensor,
                       penalty: float) -> torch.Tensor:
    """Penalise once every vocab id present in the window. logits (B, V);
    ring (B, W) int with -1 for empty slots."""
    idx = torch.arange(logits.shape[-1], device=logits.device)
    member = (idx[None, :, None] == ring[:, None, :]).any(dim=-1)
    penalised = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(member, penalised, logits)


def _categorical(logp: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """One draw per row from softmax(logp) (rows may hold -inf)."""
    probs = torch.softmax(logp, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0]


def topk_softmax_topp_sample(logits: torch.Tensor, gen: torch.Generator,
                             top_k: int, temperature: float,
                             top_p: float) -> torch.Tensor:
    """top-k -> temperature softmax -> nucleus cut -> categorical, per row
    of logits (B, V): position j of the sorted top-k stays iff the mass
    before it is < top_p. Returns (B,) int64."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    top_vals, top_idx = torch.topk(logits, top_k, dim=-1)
    probs = torch.softmax(top_vals / max(temperature, 1e-6), dim=-1)
    csum = torch.cumsum(probs, dim=-1)
    shifted = torch.cat([torch.zeros_like(csum[:, :1]), csum[:, :-1]], -1)
    logp = torch.where(shifted < top_p,
                       torch.log(torch.clamp(probs, min=1e-30)),
                       torch.full_like(probs, -float("inf")))
    choice = _categorical(logp, gen)
    return torch.gather(top_idx, 1, choice[:, None])[:, 0]


def topk_temperature_sample(logits: torch.Tensor, gen: torch.Generator,
                            top_k: int, temperature: float) -> torch.Tensor:
    """Plain top-k + temperature categorical per row; (B,) int64."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    top_vals, top_idx = torch.topk(logits, top_k, dim=-1)
    scaled = (top_vals - top_vals.amax(-1, keepdim=True)) / max(
        temperature, 1e-6)
    choice = _categorical(scaled, gen)
    return torch.gather(top_idx, 1, choice[:, None])[:, 0]


def sample_code0(logits: torch.Tensor, ring: torch.Tensor,
                 step: torch.Tensor, n_text_tokens: torch.Tensor,
                 gen: torch.Generator, cfg: SamplingConfig) -> torch.Tensor:
    """The full code_0 policy per row; (B,) int32, possibly EOS."""
    logits = mask_code0_logits(logits.float())
    logits, force = eos_boost(logits, step, n_text_tokens, cfg)
    logits = repetition_penalty(logits, ring, cfg.repetition_penalty)
    tok = topk_softmax_topp_sample(logits, gen, cfg.top_k, cfg.temperature,
                                   cfg.top_p).to(torch.int32)
    return torch.where(force, torch.full_like(tok, CODEC_EOS_ID), tok)


def ring_push(ring: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """Shift each row's window left and append value (newest last)."""
    return torch.cat([ring[..., 1:], value.to(ring.dtype)[..., None]], -1)
