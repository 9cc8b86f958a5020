"""K5: one-token GQA decode attention over the dense KV cache
(csrc/decode_attention.cu), replacing the TPU kernel
qwen3_tts_tpu/ops/pallas/decode_attention.py :: decode_attention_pallas.

q (B, Hq, Dh) post-RoPE queries; k, v (B, S, Hkv, Dh), the layer's cache
with the new row already written at pos; pos (B,): attend keys 0..pos.
Returns (B, Hq*Dh) in q's dtype, all arithmetic in f32. The kernel splits
the positions of each (row, kv head) into NSPLIT chunks of ceil(S /
NSPLIT), one block of a thread-block cluster each, and each chunk into
WARPS sub-chunks, one warp each; every sub-chunk keeps its own max,
exp-sum and unnormalised P.V, a block merges its warps' and the cluster
its blocks' in index order. The plain version below adds up in the
kernel's order (ops/kernels/common.py), so on the card the two agree bit
for bit."""

from __future__ import annotations

import functools

import torch

from qwen3_tts_tpu_torch.ops.kernels import _build
from qwen3_tts_tpu_torch.ops.kernels.common import (lane_sum, merge_partials,
                                                    pv_valid, row_dot)

NSPLIT = 8            # blocks per (row, kv head): one cluster (DA_NSPLIT)
WARPS = 4             # sub-chunks of a chunk, one warp each (DA_WARPS)
MAX_G = 8             # query heads per kv head (DA_MAXG)
MAX_DH = 256          # Dh: a multiple of 8 whose Dh / 8 is a power of two


def _partial(qf, k, v, pos, s0: int, s1: int):
    """(m, l, o, live) of positions [s0, s1) as one warp has them: scores
    in the lane groups' order, their max, e = exp(s - m), the lanes'
    strided sum of e and the P.V chains in position order; live: s0 <=
    pos, per row."""
    Dh = qf.shape[-1]
    Kc = k[:, s0:s1].float().permute(0, 2, 1, 3)[:, :, None]  # B,Hkv,1,n,Dh
    Vc = v[:, s0:s1].float().permute(0, 2, 1, 3)[:, :, None]
    valid = (torch.arange(s0, s1, device=qf.device)[None, :]
             <= pos[:, None])[:, None, None, :]
    sc = row_dot(qf, Kc) * (1.0 / Dh ** 0.5)                   # B,Hkv,G,n
    m = torch.where(valid, sc, torch.full_like(sc, -torch.inf)).amax(-1)
    e = torch.where(valid, torch.exp(sc - m[..., None]), torch.zeros_like(sc))
    return m, lane_sum(e), pv_valid(e, Vc, valid), (s0 <= pos)[:, None, None]


def _merge(parts):
    return merge_partials(*(torch.stack(x) for x in zip(*parts)))


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           pos: torch.Tensor, *,
                           nsplit: int = NSPLIT) -> torch.Tensor:
    """The kernel's plain PyTorch version, over ``nsplit`` chunks of
    positions. Positions past a row's pos are not read: masked at -1e30
    their exp is exactly 0."""
    B, Hq, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    pos = pos.long().clamp(0, S - 1)
    last = int(pos.max())
    C = -(-S // nsplit)
    W = -(-C // WARPS)
    qf = q.float().reshape(B, Hkv, G, 1, Dh)
    blocks = []
    for c0 in range(0, last + 1, C):                  # chunks some row needs
        c1 = min(c0 + C, S)
        warps = [_partial(qf, k, v, pos, w0, min(w0 + W, c1))
                 for w0 in range(c0, min(c1, last + 1), W)]
        blocks.append((*_merge(warps), (c0 <= pos)[:, None, None]))
    _, L, O = _merge(blocks)
    return (O / L[..., None]).reshape(B, Hq * Dh).to(q.dtype)


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"decode_attention: {msg}")


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          pos: torch.Tensor) -> torch.Tensor:
    """Launch K5; same contract as decode_attention_plain. The kernel
    itself refuses (RuntimeError) an S whose chunk's scores and staging
    buffers do not fit a block's shared memory (S in the tens of
    thousands)."""
    B, Hq, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    _check(k.shape == (B, S, Hkv, Dh) and v.shape == k.shape,
           f"k {tuple(k.shape)} / v {tuple(v.shape)} for q {tuple(q.shape)}")
    _check(Hq % Hkv == 0 and 1 <= Hq // Hkv <= MAX_G,
           f"{Hq} query heads over {Hkv} kv heads (at most {MAX_G} a group)")
    _check(8 <= Dh <= MAX_DH and Dh % 8 == 0 and (Dh // 8) & (Dh // 8 - 1)
           == 0, f"head dim {Dh} (8, 16, ..., {MAX_DH})")
    _check(q.dtype in (torch.bfloat16, torch.float32), f"q {q.dtype}")
    _check(k.dtype == v.dtype and k.dtype in (torch.bfloat16, torch.float32),
           f"k {k.dtype} / v {v.dtype}")
    _check(pos.shape == (B,), f"pos shape {tuple(pos.shape)}")
    _check(all(t.is_cuda and t.device == q.device for t in (k, v, pos)),
           "every operand must be on q's CUDA device")
    _check(k.is_contiguous() and v.is_contiguous(),
           "k and v must be contiguous (B, S, Hkv, Dh)")
    # cp.async copies 16-byte pieces of every (s, h) row (Dh % 8 == 0
    # keeps each row's start aligned)
    _check(k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0,
           "k and v must be 16-byte aligned")
    q = q.contiguous()
    if q.data_ptr() % 16:         # the kernel reads q rows 16 bytes at a time
        q = q.clone()
    # the kernel reads int32 or int64 positions as they come: no cast launch
    if pos.dtype not in (torch.int32, torch.int64):
        pos = pos.to(torch.int32)
    pos = pos.contiguous()
    out = torch.empty((B, Hq * Dh), dtype=q.dtype, device=q.device)
    _fn()(q.data_ptr(), int(q.dtype == torch.bfloat16), k.data_ptr(),
          v.data_ptr(), int(k.dtype == torch.bfloat16), pos.data_ptr(),
          int(pos.dtype == torch.int64), out.data_ptr(), B, S, Hq, Hkv, Dh,
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
    return _build.function("q3_decode_attention", "pippipipiiiiiip")
