"""Sampling policies. Twin of qwen3_tts_tpu/ops/sampling.py, batched over
a leading row axis.

code_0 policy: mask to audio codes + EOS, adaptive EOS boost, repetition
penalty over a 30-token window, then top-k -> temperature softmax ->
top-p nucleus cut -> categorical. CP group policy: top-k + temperature.

The deterministic transforms (mask, boost, penalty, ring) are bit-equal
to JAX. Draws are keyed per row, as JAX's are: every row carries its own
int64 key, and a draw's random numbers are a counter-based hash of (the
row's key, the row's token counter, the draw site). So a row's samples
never depend on which other rows share the batch. A draw is a Gumbel-max
over the masked log-probabilities, with the noise of the murmur-style
hash that K2 samples with in-kernel (``gumbel_noise``). The bits differ
from ``jax.random``'s; the distributions are the same. Temperature 0
means argmax (first index).
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

from qwen3_tts_tpu_torch.config import (
    CODEC_EOS_ID,
    NUM_AUDIO_CODES,
    SamplingConfig,
)

NEG = -1e10
M32 = 0xFFFFFFFF

# draw sites: which draw of a token a seed is for
SITE_CODE0 = 0      # code_0 (sample_code0)
SITE_CP_GROUP1 = 1  # code predictor group 1 (lm_head_0)
SITE_CP_STEPS = 2   # code predictor groups 2..15 (K2's per-row seed)


def mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2**32 for int64 a in [0, 2**32), without int64
    overflow: split c into 16-bit halves."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & M32


def gumbel_noise(seed_col: torch.Tensor, step: int, n: int) -> torch.Tensor:
    """Gumbel noise (N, n) f32 from the hash PRNG of K2's in-kernel
    sampler: column j of row r hashes (seed_col[r], step, j), uint32
    emulated in int64. seed_col (N, 1) int, read as its low 32 bits."""
    iota = torch.arange(n, device=seed_col.device, dtype=torch.int64)
    seed = seed_col.long() & M32
    bits = (mul32(seed, 2654435761) + ((int(step) * 40503) & M32)
            + mul32(iota, 2246822519)[None, :]) & M32
    bits = bits ^ (bits >> 16)
    bits = mul32(bits, 2246822519)
    bits = bits ^ (bits >> 13)
    bits = mul32(bits, 3266489917)
    bits = bits ^ (bits >> 16)
    u = (bits >> 9).float() * (1.0 / (1 << 23))
    u = u * (1.0 - 1e-6) + 1e-7
    return -torch.log(-torch.log(u))


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on int64 values in [0, 2**32)."""
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def draw_seeds(keys: torch.Tensor, counter: torch.Tensor,
               site) -> torch.Tensor:
    """The seed of a draw: a hash of (key, counter, site), broadcast
    over the three. keys int64 row keys; counter the rows' token
    counters; site an int or an int64 tensor. Returns int64 in
    [0, 2**32)."""
    k = keys.long()
    h = _fmix32((k & M32) ^ (((site + 1) * 0x9E3779B9) & M32))
    h = _fmix32(h ^ ((k >> 32) & M32))
    return _fmix32((h + (counter.long() & M32)) & M32)


def token_seeds(keys: torch.Tensor, counter: torch.Tensor) -> torch.Tensor:
    """(B, 3) seeds of a token's three draws, columns SITE_CODE0,
    SITE_CP_GROUP1 and SITE_CP_STEPS, hashed in one pass. keys (B,)
    int64, counter (B,)."""
    sites = torch.arange(3, device=keys.device)
    return draw_seeds(keys[:, None], counter[:, None], sites)


def as_int32(seeds: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> the int32 with the same bits."""
    s = seeds.long() & M32
    return torch.where(s >= 1 << 31, s - (1 << 32), s).to(torch.int32)


def key_of(seed: int) -> int:
    """The row key of a request seed (any Python int)."""
    return int(seed) & ((1 << 63) - 1)


def batch_keys(seeds: Union[int, Sequence[int], torch.Tensor], B: int,
               device=None) -> torch.Tensor:
    """(B,) int64 row keys. B seeds give one key each, as they are. One
    int seed s gives row 0 the key s and every other row i a key hashed
    from (s, i), so the rows draw independent streams and row 0 of a
    batch draws what a solo request with seed s draws."""
    if isinstance(seeds, int):
        base = torch.tensor([key_of(seeds)], dtype=torch.int64)
        rows = torch.arange(B, dtype=torch.int64)
        mixed = (draw_seeds(base.expand(B), rows, -1) << 31) ^ base
        keys = torch.where(rows == 0, base, mixed)
    else:
        if not isinstance(seeds, torch.Tensor):
            seeds = [key_of(s) for s in seeds]
        keys = torch.as_tensor(seeds, dtype=torch.int64).reshape(-1).cpu()
        if keys.shape[0] != B:
            raise ValueError(f"{keys.shape[0]} seeds for {B} rows")
    return keys.to(device)


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


def _categorical(logp: torch.Tensor, seeds: torch.Tensor) -> torch.Tensor:
    """One draw per row from softmax(logp) (rows may hold -inf): the
    first index of max(logp + Gumbel noise of the row's seed)."""
    z = logp + gumbel_noise(seeds.reshape(-1, 1), 0, logp.shape[-1])
    return torch.argmax(z, dim=-1)


def topk_softmax_topp_sample(logits: torch.Tensor, seeds: torch.Tensor,
                             top_k: int, temperature: float,
                             top_p: float) -> torch.Tensor:
    """top-k -> temperature softmax -> nucleus cut -> categorical, per row
    of logits (B, V): position j of the sorted top-k stays iff the mass
    before it is < top_p. seeds (B,) from draw_seeds. Returns (B,)
    int64."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    top_vals, top_idx = torch.topk(logits, top_k, dim=-1)
    probs = torch.softmax(top_vals / max(temperature, 1e-6), dim=-1)
    csum = torch.cumsum(probs, dim=-1)
    shifted = torch.cat([torch.zeros_like(csum[:, :1]), csum[:, :-1]], -1)
    logp = torch.where(shifted < top_p,
                       torch.log(torch.clamp(probs, min=1e-30)),
                       torch.full_like(probs, -float("inf")))
    choice = _categorical(logp, seeds)
    return torch.gather(top_idx, 1, choice[:, None])[:, 0]


def topk_temperature_sample(logits: torch.Tensor, seeds: torch.Tensor,
                            top_k: int, temperature: float) -> torch.Tensor:
    """Plain top-k + temperature categorical per row; (B,) int64."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    top_vals, top_idx = torch.topk(logits, top_k, dim=-1)
    scaled = (top_vals - top_vals.amax(-1, keepdim=True)) / max(
        temperature, 1e-6)
    choice = _categorical(scaled, seeds)
    return torch.gather(top_idx, 1, choice[:, None])[:, 0]


def sample_code0(logits: torch.Tensor, ring: torch.Tensor,
                 step: torch.Tensor, n_text_tokens: torch.Tensor,
                 seeds: torch.Tensor, cfg: SamplingConfig) -> torch.Tensor:
    """The full code_0 policy per row; (B,) int32, possibly EOS. seeds
    (B,): column SITE_CODE0 of token_seeds(keys, step)."""
    logits = mask_code0_logits(logits.float())
    logits, force = eos_boost(logits, step, n_text_tokens, cfg)
    logits = repetition_penalty(logits, ring, cfg.repetition_penalty)
    tok = topk_softmax_topp_sample(logits, seeds, cfg.top_k, cfg.temperature,
                                   cfg.top_p).to(torch.int32)
    return torch.where(force, torch.full_like(tok, CODEC_EOS_ID), tok)


def ring_push(ring: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """Shift each row's window left and append value (newest last)."""
    return torch.cat([ring[..., 1:], value.to(ring.dtype)[..., None]], -1)
