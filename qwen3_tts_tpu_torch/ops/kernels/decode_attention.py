"""K5: one-token GQA decode attention over the dense KV cache
(csrc/decode_attention.cu), replacing the TPU kernel
qwen3_tts_tpu/ops/pallas/decode_attention.py :: decode_attention_pallas.

q (B, Hq, Dh) post-RoPE queries; k, v (B, S, Hkv, Dh), the layer's cache
with the new row already written at pos; pos (B,): attend keys 0..pos.
Returns (B, Hq*Dh) in q's dtype. Scores q.K * (1/sqrt(Dh)), the
max-subtracted softmax, p / sum(p) and P.V are f32. The plain version
below adds up in the kernel's order (ops/kernels/common.py), so on the
card the two agree bit for bit."""

from __future__ import annotations

import functools

import torch

from qwen3_tts_tpu_torch.ops.kernels import _build
from qwen3_tts_tpu_torch.ops.kernels.common import (NEG, lane_dot, pv,
                                                    softmax_sum)

MAX_G = 8             # query heads per kv head (DA_MAXG in the source)


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           pos: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version. Positions past every row's pos
    are left out: masked at -1e30 their exp is exactly 0."""
    B, Hq, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    pos = pos.long().clamp(0, S - 1)
    n = int(pos.max()) + 1
    qf = q.float().reshape(B, Hkv, G, 1, Dh)
    Kh = k[:, :n].float().permute(0, 2, 1, 3)[:, :, None]   # (B,Hkv,1,n,Dh)
    Vh = v[:, :n].float().permute(0, 2, 1, 3)[:, :, None]
    sc = lane_dot(qf, Kh) * (1.0 / Dh ** 0.5)                 # (B,Hkv,G,n)
    valid = (torch.arange(n, device=q.device)[None, :]
             <= pos[:, None])[:, None, None, :]
    sc = torch.where(valid, sc, torch.full_like(sc, NEG))
    e = torch.exp(sc - sc.amax(-1, keepdim=True))
    e = torch.where(valid, e, torch.zeros_like(e))
    p = e / softmax_sum(e)[..., None]
    return pv(p, Vh, n).reshape(B, Hq * Dh).to(q.dtype)


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"decode_attention: {msg}")


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          pos: torch.Tensor) -> torch.Tensor:
    """Launch K5; same contract as decode_attention_plain."""
    B, Hq, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    _check(k.shape == (B, S, Hkv, Dh) and v.shape == k.shape,
           f"k {tuple(k.shape)} / v {tuple(v.shape)} for q {tuple(q.shape)}")
    _check(Hq % Hkv == 0 and Hq // Hkv <= MAX_G
           and (Hq // Hkv) * Dh <= 512, f"heads {Hq}/{Hkv} x {Dh}")
    _check(q.dtype in (torch.bfloat16, torch.float32), f"q {q.dtype}")
    _check(k.dtype == v.dtype and k.dtype in (torch.bfloat16, torch.float32),
           f"k {k.dtype} / v {v.dtype}")
    _check(pos.shape == (B,), f"pos shape {tuple(pos.shape)}")
    _check(all(t.is_cuda and t.device == q.device for t in (k, v, pos)),
           "every operand must be on q's CUDA device")
    _check(k.is_contiguous() and v.is_contiguous(),
           "k and v must be contiguous (B, S, Hkv, Dh)")
    q = q.contiguous()
    pos32 = pos.to(torch.int32).contiguous()
    out = torch.empty((B, Hq * Dh), dtype=q.dtype, device=q.device)
    _fn()(q.data_ptr(), int(q.dtype == torch.bfloat16), k.data_ptr(),
          v.data_ptr(), int(k.dtype == torch.bfloat16), pos32.data_ptr(),
          out.data_ptr(), B, S, Hq, Hkv, Dh,
          _build.f32_bits(1.0 / Dh ** 0.5), _build.stream())
    decode_attention.launches += 1
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: torch.Tensor) -> torch.Tensor:
    """K5 on a CUDA tensor, its plain version on a CPU tensor; (B, Hq*Dh)
    in q's dtype."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, pos)
    if q.is_cuda:
        return decode_attention_cuda(q, k, v, pos)
    raise ValueError(f"decode_attention: unsupported device {q.device}")


decode_attention.launches = 0


@functools.cache
def _fn():
    return _build.function("q3_decode_attention", "pippippiiiiiip")
