"""K6: one-token GQA decode attention over a per-row scaled int8 KV cache
(csrc/kv_int8.cu), replacing the TPU kernel
qwen3_tts_tpu/ops/pallas/kv_int8.py :: decode_attention_kv_int8, and the
cache's quantizer ``quantize_kv_rows`` (plain torch ops there and here).

q (B, Hq, Dh) post-RoPE queries; kq, vq (B, Hkv, S, Dh) int8, the layer's
cache in the kernel-native layout with the new row already written at
pos; ks, vs (B, Hkv, S) f32 row scales; pos (B,): attend keys 0..pos.
Returns (B, Hq*Dh) in q's dtype. Each cache element is dequantized as
float(kq) * ks in f32 before the dot; scores q.K * (1/sqrt(Dh)), the
max-subtracted softmax, p / sum(p) and P.V are f32. The plain version
below adds up in the kernel's order (ops/kernels/common.py), so on the
card the two agree bit for bit."""

from __future__ import annotations

import functools

import torch

from qwen3_tts_tpu_torch.ops.kernels import _build
from qwen3_tts_tpu_torch.ops.kernels.common import (NEG, lane_dot, pv,
                                                    softmax_sum)

MAX_G = 8             # query heads per kv head (KV8_MAXG in the source)


def quantize_kv_rows(rows: torch.Tensor):
    """Per-row symmetric int8: rows (..., Dh) -> (int8 rows, f32 scales
    (...,)), bit-equal to the JAX package's: scale = max|row| / 127, the
    row times 1/scale rounded half to even and clipped to +-127. A zero
    row gives zeros and scale 0."""
    r = rows.float()
    scale = r.abs().amax(dim=-1) / 127.0
    nz = scale > 0
    inv = torch.where(nz, 1.0 / torch.where(nz, scale, torch.ones_like(scale)),
                      torch.zeros_like(scale))
    q = torch.clamp(torch.round(r * inv[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """float(q) * scale per row, in f32: the kernel's dequantize."""
    return q.float() * scale.float()[..., None]


def decode_attention_kv_int8_plain(q: torch.Tensor, kq: torch.Tensor,
                                   ks: torch.Tensor, vq: torch.Tensor,
                                   vs: torch.Tensor,
                                   pos: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version. Positions past every row's pos
    are left out: masked at -1e30 their exp is exactly 0."""
    B, Hq, Dh = q.shape
    Hkv, S = kq.shape[1], kq.shape[2]
    G = Hq // Hkv
    pos = pos.long().clamp(0, S - 1)
    n = int(pos.max()) + 1
    qf = q.float().reshape(B, Hkv, G, 1, Dh)
    K = dequantize_kv_rows(kq[:, :, :n], ks[:, :, :n])[:, :, None]
    V = dequantize_kv_rows(vq[:, :, :n], vs[:, :, :n])[:, :, None]
    sc = lane_dot(qf, K) * (1.0 / Dh ** 0.5)                  # (B,Hkv,G,n)
    valid = (torch.arange(n, device=q.device)[None, :]
             <= pos[:, None])[:, None, None, :]
    sc = torch.where(valid, sc, torch.full_like(sc, NEG))
    e = torch.exp(sc - sc.amax(-1, keepdim=True))
    e = torch.where(valid, e, torch.zeros_like(e))
    p = e / softmax_sum(e)[..., None]
    return pv(p, V, n).reshape(B, Hq * Dh).to(q.dtype)


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"decode_attention_kv_int8: {msg}")


def decode_attention_kv_int8_cuda(q: torch.Tensor, kq: torch.Tensor,
                                  ks: torch.Tensor, vq: torch.Tensor,
                                  vs: torch.Tensor,
                                  pos: torch.Tensor) -> torch.Tensor:
    """Launch K6; same contract as decode_attention_kv_int8_plain."""
    B, Hq, Dh = q.shape
    Hkv, S = kq.shape[1], kq.shape[2]
    _check(kq.shape == (B, Hkv, S, Dh) and vq.shape == kq.shape,
           f"kq {tuple(kq.shape)} / vq {tuple(vq.shape)} for q "
           f"{tuple(q.shape)}")
    _check(ks.shape == (B, Hkv, S) and vs.shape == ks.shape,
           f"ks {tuple(ks.shape)} / vs {tuple(vs.shape)}")
    _check(Hq % Hkv == 0 and Hq // Hkv <= MAX_G
           and (Hq // Hkv) * Dh <= 512, f"heads {Hq}/{Hkv} x {Dh}")
    _check(q.dtype in (torch.bfloat16, torch.float32), f"q {q.dtype}")
    _check(kq.dtype == vq.dtype == torch.int8, f"kq {kq.dtype} / vq "
                                               f"{vq.dtype}")
    _check(ks.dtype == vs.dtype == torch.float32,
           f"ks {ks.dtype} / vs {vs.dtype}")
    _check(pos.shape == (B,), f"pos shape {tuple(pos.shape)}")
    _check(all(t.is_cuda and t.device == q.device
               for t in (kq, ks, vq, vs, pos)),
           "every operand must be on q's CUDA device")
    _check(all(t.is_contiguous() for t in (kq, ks, vq, vs)),
           "the cache and its scales must be contiguous")
    q = q.contiguous()
    pos32 = pos.to(torch.int32).contiguous()
    out = torch.empty((B, Hq * Dh), dtype=q.dtype, device=q.device)
    _fn()(q.data_ptr(), int(q.dtype == torch.bfloat16), kq.data_ptr(),
          ks.data_ptr(), vq.data_ptr(), vs.data_ptr(), pos32.data_ptr(),
          out.data_ptr(), B, S, Hq, Hkv, Dh,
          _build.f32_bits(1.0 / Dh ** 0.5), _build.stream())
    decode_attention_kv_int8.launches += 1
    return out


def decode_attention_kv_int8(q: torch.Tensor, kq: torch.Tensor,
                             ks: torch.Tensor, vq: torch.Tensor,
                             vs: torch.Tensor,
                             pos: torch.Tensor) -> torch.Tensor:
    """K6 on a CUDA tensor, its plain version on a CPU tensor; (B, Hq*Dh)
    in q's dtype."""
    if q.device.type == "cpu":
        return decode_attention_kv_int8_plain(q, kq, ks, vq, vs, pos)
    if q.is_cuda:
        return decode_attention_kv_int8_cuda(q, kq, ks, vq, vs, pos)
    raise ValueError(f"decode_attention_kv_int8: unsupported device "
                     f"{q.device}")


decode_attention_kv_int8.launches = 0


@functools.cache
def _fn():
    return _build.function("q3_decode_attention_kv_int8", "pippppppiiiiiip")
