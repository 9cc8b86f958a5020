"""K4: one-token GQA decode attention over a block-paged KV pool through a
per-row page table (csrc/paged_attention.cu), replacing the TPU kernel
qwen3_tts_tpu/ops/pallas/paged_attention.py ::
paged_decode_attention_pallas (dispatcher: paged_decode_attention).

A row's logical position s lives at pool[table[b, s // psz], s % psz];
table entries past a row's allocation are 0, a reserved page that is only
ever read masked. The attention walks the logical pages in order with an
online softmax in f32 and returns f32; the dispatcher casts to q's dtype.
The plain version below adds up in the kernel's order
(ops/kernels/common.py), so on the card the two agree bit for bit."""

from __future__ import annotations

import functools

import torch

from qwen3_tts_tpu_torch.ops.kernels import _build
from qwen3_tts_tpu_torch.ops.kernels.common import (NEG, lane_dot, pv,
                                                    softmax_sum)

MAX_G = 8             # query heads per kv head (PA_MAXG in the source)


def paged_gather_kv(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Each row's logical K/V as a dense copy: pool (2, P, psz, Hkv, Dh),
    table (B, MAXP) -> (2, B, MAXP*psz, Hkv, Dh)."""
    g = pool[:, table.long()]                 # (2, B, MAXP, psz, Hkv, Dh)
    two, B, MAXP, psz, Hkv, Dh = g.shape
    return g.reshape(two, B, MAXP * psz, Hkv, Dh)


def paged_attention_plain(q: torch.Tensor, pool_k: torch.Tensor,
                          pool_v: torch.Tensor, table: torch.Tensor,
                          pos: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version: q (B, Hq, Dh), pool_k/pool_v
    (P, psz, Hkv, Dh), table (B, MAXP), pos (B,) -> (B, Hq*Dh) f32.
    Pages wholly past every row's pos are left out: for them the update
    is exactly the identity (alpha = 1, p = 0)."""
    B, Hq, Dh = q.shape
    psz, Hkv = pool_k.shape[1], pool_k.shape[2]
    MAXP = table.shape[1]
    G = Hq // Hkv
    scale = 1.0 / Dh ** 0.5
    pos = pos.long().clamp(0, MAXP * psz - 1)
    dev = q.device
    qf = q.float().reshape(B, Hkv, G, 1, Dh)
    m = torch.full((B, Hkv, G), NEG, device=dev)
    l = torch.zeros((B, Hkv, G), device=dev)
    acc = torch.zeros((B, Hkv, G, Dh), device=dev)
    row = torch.arange(psz, device=dev)
    for j in range(int(pos.max()) // psz + 1):
        pid = table[:, j].long()
        Kh = pool_k[pid].float().permute(0, 2, 1, 3)[:, :, None]
        Vh = pool_v[pid].float().permute(0, 2, 1, 3)[:, :, None]
        sc = lane_dot(qf, Kh) * scale                       # (B,Hkv,G,psz)
        valid = ((j * psz + row)[None, :]
                 <= pos[:, None])[:, None, None, :]
        sc = torch.where(valid, sc, torch.full_like(sc, NEG))
        m_new = torch.maximum(m, sc.amax(-1))
        alpha = torch.exp(m - m_new)
        e = torch.exp(sc - m_new[..., None])
        e = torch.where(valid, e, torch.zeros_like(e))
        l = l * alpha + softmax_sum(e)
        acc = acc * alpha[..., None] + pv(e, Vh, psz)
        m = m_new
    out = acc / torch.where(l > 0, l, torch.ones_like(l))[..., None]
    return out.reshape(B, Hq * Dh)


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"paged_attention: {msg}")


def paged_attention_cuda(q: torch.Tensor, pool_k: torch.Tensor,
                         pool_v: torch.Tensor, table: torch.Tensor,
                         pos: torch.Tensor) -> torch.Tensor:
    """Launch K4; same contract as paged_attention_plain."""
    B, Hq, Dh = q.shape
    P, psz, Hkv = pool_k.shape[0], pool_k.shape[1], pool_k.shape[2]
    MAXP = table.shape[1]
    _check(pool_k.shape == (P, psz, Hkv, Dh) and pool_v.shape == pool_k.shape,
           f"pool {tuple(pool_k.shape)} / {tuple(pool_v.shape)} for q "
           f"{tuple(q.shape)}")
    _check(Hq % Hkv == 0 and Hq // Hkv <= MAX_G
           and (Hq // Hkv) * Dh <= 512 and psz <= 512,
           f"heads {Hq}/{Hkv} x {Dh}, page size {psz}")
    _check(q.dtype in (torch.bfloat16, torch.float32), f"q {q.dtype}")
    _check(pool_k.dtype == pool_v.dtype
           and pool_k.dtype in (torch.bfloat16, torch.float32),
           f"pool {pool_k.dtype} / {pool_v.dtype}")
    _check(table.shape == (B, MAXP) and pos.shape == (B,),
           f"table {tuple(table.shape)} / pos {tuple(pos.shape)}")
    _check(all(t.is_cuda and t.device == q.device
               for t in (pool_k, pool_v, table, pos)),
           "every operand must be on q's CUDA device")
    _check(pool_k.is_contiguous() and pool_v.is_contiguous(),
           "the pool must be contiguous (P, psz, Hkv, Dh)")
    q = q.contiguous()
    table32 = table.to(torch.int32).contiguous()
    pos32 = pos.to(torch.int32).contiguous()
    out = torch.empty((B, Hq * Dh), dtype=torch.float32, device=q.device)
    _fn()(q.data_ptr(), int(q.dtype == torch.bfloat16), pool_k.data_ptr(),
          pool_v.data_ptr(), int(pool_k.dtype == torch.bfloat16),
          table32.data_ptr(), pos32.data_ptr(), out.data_ptr(), B, MAXP,
          psz, Hq, Hkv, Dh, _build.f32_bits(1.0 / Dh ** 0.5),
          _build.stream())
    paged_decode_attention.launches += 1
    return out


def paged_decode_attention(q: torch.Tensor, pool: torch.Tensor,
                           table: torch.Tensor,
                           pos: torch.Tensor) -> torch.Tensor:
    """q (B, Hq, Dh), pool (2, P, psz, Hkv, Dh) one layer's K/V pool,
    table (B, MAXP) int32, pos (B,): K4 on a CUDA tensor, its plain
    version on a CPU tensor. Returns (B, Hq*Dh) in q's dtype."""
    if q.device.type == "cpu":
        out = paged_attention_plain(q, pool[0], pool[1], table, pos)
    elif q.is_cuda:
        out = paged_attention_cuda(q, pool[0], pool[1], table, pos)
    else:
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    return out.to(q.dtype)


paged_decode_attention.launches = 0


@functools.cache
def _fn():
    return _build.function("q3_paged_attention", "pippipppiiiiiiip")
