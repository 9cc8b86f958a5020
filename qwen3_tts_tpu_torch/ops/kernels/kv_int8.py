"""K6: one-token GQA decode attention over a per-row scaled int8 KV cache,
replacing the TPU kernel qwen3_tts_tpu/ops/pallas/kv_int8.py ::
decode_attention_kv_int8, and the cache's quantizer ``quantize_kv_rows``
(plain torch ops there and here).

q (B, Hq, Dh) post-RoPE queries; kq, vq (B, Hkv, S, Dh) int8, the layer's
cache in the kernel-native layout with the new row already written at
pos; ks, vs (B, Hkv, S) f32 row scales; pos (B,) int32 or int64: attend
keys 0..pos. Returns (B, Hq*Dh) in q's dtype. Each cache element is
dequantized as float(kq) * ks in f32 before it is used.

The kernel is the int8 mode of K5's body (csrc/decode_attention.cu,
q3_decode_attention_kv_int8): the positions of each (row, kv head) are
split over a cluster of 8 blocks and their warps exactly as K5 splits a
dense cache, and each row is dequantized in registers as it is read. So
the plain version below is K5's plain version over the dequantized rows,
and on the card kernel and plain version agree bit for bit."""

from __future__ import annotations

import functools

import torch

from qwen3_tts_tpu_torch.ops.kernels import _build
from qwen3_tts_tpu_torch.ops.kernels.decode_attention import (
    MAX_DH, MAX_G, NSPLIT, decode_attention_plain)


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
                                   vs: torch.Tensor, pos: torch.Tensor, *,
                                   nsplit: int = NSPLIT) -> torch.Tensor:
    """The kernel's plain PyTorch version: decode_attention_plain over
    every row dequantized (the f32 values the kernel forms in registers)
    and moved to K5's (B, S, Hkv, Dh) layout."""
    K = dequantize_kv_rows(kq, ks).transpose(1, 2)
    V = dequantize_kv_rows(vq, vs).transpose(1, 2)
    return decode_attention_plain(q, K, V, pos, nsplit=nsplit)


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"decode_attention_kv_int8: {msg}")


def decode_attention_kv_int8_cuda(q: torch.Tensor, kq: torch.Tensor,
                                  ks: torch.Tensor, vq: torch.Tensor,
                                  vs: torch.Tensor,
                                  pos: torch.Tensor) -> torch.Tensor:
    """Launch K6; same contract as decode_attention_kv_int8_plain. Every
    shape the kernel does not take raises ValueError before the launch;
    the kernel itself refuses (RuntimeError) an S whose chunk does not fit
    a block's shared memory, as K5 does."""
    B, Hq, Dh = q.shape
    Hkv, S = kq.shape[1], kq.shape[2]
    _check(kq.shape == (B, Hkv, S, Dh) and vq.shape == kq.shape,
           f"kq {tuple(kq.shape)} / vq {tuple(vq.shape)} for q "
           f"{tuple(q.shape)}")
    _check(ks.shape == (B, Hkv, S) and vs.shape == ks.shape,
           f"scales ks {tuple(ks.shape)} / vs {tuple(vs.shape)}, want "
           f"{(B, Hkv, S)}")
    _check(Hq % Hkv == 0 and 1 <= Hq // Hkv <= MAX_G,
           f"{Hq} query heads over {Hkv} kv heads (at most {MAX_G} a group)")
    # 16-byte cp.async pieces of an int8 row; Dh / 8 lanes share a row
    _check(16 <= Dh <= MAX_DH and Dh % 16 == 0 and (Dh // 8) & (Dh // 8 - 1)
           == 0, f"head dim {Dh} (16, 32, ..., {MAX_DH})")
    _check(q.dtype in (torch.bfloat16, torch.float32), f"q {q.dtype}")
    _check(kq.dtype == vq.dtype == torch.int8, f"kq {kq.dtype} / vq "
                                               f"{vq.dtype}")
    _check(ks.dtype == vs.dtype == torch.float32,
           f"scales ks {ks.dtype} / vs {vs.dtype}")
    _check(pos.shape == (B,), f"pos shape {tuple(pos.shape)}")
    _check(all(t.is_contiguous() for t in (kq, ks, vq, vs)),
           "the cache and its scales must be contiguous")
    _check(kq.data_ptr() % 16 == 0 and vq.data_ptr() % 16 == 0,
           "kq and vq must be 16-byte aligned")
    _check(all(t.is_cuda and t.device == q.device
               for t in (q, kq, ks, vq, vs, pos)),
           "every operand must be on q's CUDA device")
    q = q.contiguous()
    if q.data_ptr() % 16:         # the kernel reads q rows 16 bytes at a time
        q = q.clone()
    # the kernel reads int32 or int64 positions as they come: no cast launch
    if pos.dtype not in (torch.int32, torch.int64):
        pos = pos.to(torch.int32)
    pos = pos.contiguous()
    out = torch.empty((B, Hq * Dh), dtype=q.dtype, device=q.device)
    _fn()(q.data_ptr(), int(q.dtype == torch.bfloat16), kq.data_ptr(),
          ks.data_ptr(), vq.data_ptr(), vs.data_ptr(), pos.data_ptr(),
          int(pos.dtype == torch.int64), out.data_ptr(), B, S, Hq, Hkv, Dh,
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
    return _build.function("q3_decode_attention_kv_int8",
                           "pipppppipiiiiiip")
