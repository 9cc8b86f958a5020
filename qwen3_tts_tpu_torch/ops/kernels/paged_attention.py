"""K4: one-token GQA decode attention over a block-paged KV pool through a
per-row page table (csrc/decode_attention.cu, q3_paged_attention),
replacing the TPU kernel qwen3_tts_tpu/ops/pallas/paged_attention.py ::
paged_decode_attention_pallas (dispatcher: paged_decode_attention).

A row's logical position s lives at pool[table[b, s // psz], s % psz];
table entries past a row's allocation are 0, a reserved page that is never
read (no position past pos is). K4 is K5's kernel body with the rows
addressed through the table: the positions 0 .. MAXP*psz - 1 of each (row,
kv head) are split over a cluster of 8 blocks and their warps exactly as
K5 splits a dense cache of S = MAXP*psz, and the output is stored in q's
dtype. So the plain version below is K5's plain version over the rows the
table gathers, and on the card kernel and plain version agree bit for
bit."""

from __future__ import annotations

import functools

import torch

from qwen3_tts_tpu_torch.ops.kernels import _build
from qwen3_tts_tpu_torch.ops.kernels.decode_attention import (
    MAX_DH, MAX_G, decode_attention_plain)


def _rows(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """One pool (P, psz, Hkv, Dh) read through table (B, MAXP): each
    row's logical K or V, (B, MAXP*psz, Hkv, Dh)."""
    g = pool[table.long()]                    # (B, MAXP, psz, Hkv, Dh)
    B, MAXP, psz = g.shape[:3]
    return g.reshape(B, MAXP * psz, *g.shape[3:])


def paged_gather_kv(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Each row's logical K/V as a dense copy: pool (2, P, psz, Hkv, Dh),
    table (B, MAXP) -> (2, B, MAXP*psz, Hkv, Dh)."""
    return torch.stack([_rows(pool[0], table), _rows(pool[1], table)])


def paged_attention_plain(q: torch.Tensor, pool_k: torch.Tensor,
                          pool_v: torch.Tensor, table: torch.Tensor,
                          pos: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version: q (B, Hq, Dh), pool_k/pool_v
    (P, psz, Hkv, Dh), table (B, MAXP), pos (B,) -> (B, Hq*Dh) in q's
    dtype: decode_attention_plain over the gathered rows."""
    return decode_attention_plain(q, _rows(pool_k, table),
                                  _rows(pool_v, table), pos)


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"paged_attention: {msg}")


def paged_attention_cuda(q: torch.Tensor, pool_k: torch.Tensor,
                         pool_v: torch.Tensor, table: torch.Tensor,
                         pos: torch.Tensor) -> torch.Tensor:
    """Launch K4; same contract as paged_attention_plain. The kernel
    itself refuses (RuntimeError) a MAXP*psz whose chunk does not fit a
    block's shared memory, as K5 does."""
    B, Hq, Dh = q.shape
    P, psz, Hkv = pool_k.shape[0], pool_k.shape[1], pool_k.shape[2]
    MAXP = table.shape[1]
    _check(pool_k.shape == (P, psz, Hkv, Dh) and pool_v.shape == pool_k.shape,
           f"pool {tuple(pool_k.shape)} / {tuple(pool_v.shape)} for q "
           f"{tuple(q.shape)}")
    _check(Hq % Hkv == 0 and 1 <= Hq // Hkv <= MAX_G,
           f"{Hq} query heads over {Hkv} kv heads (at most {MAX_G} a group)")
    _check(8 <= Dh <= MAX_DH and Dh % 8 == 0 and (Dh // 8) & (Dh // 8 - 1)
           == 0, f"head dim {Dh} (8, 16, ..., {MAX_DH})")
    _check(psz >= 1 and MAXP >= 1, f"page size {psz}, {MAXP} pages a row")
    _check(q.dtype in (torch.bfloat16, torch.float32), f"q {q.dtype}")
    _check(pool_k.dtype == pool_v.dtype
           and pool_k.dtype in (torch.bfloat16, torch.float32),
           f"pool {pool_k.dtype} / {pool_v.dtype}")
    _check(table.shape == (B, MAXP) and table.dtype == torch.int32,
           f"table {tuple(table.shape)} {table.dtype} (B, MAXP) int32")
    _check(pos.shape == (B,), f"pos shape {tuple(pos.shape)}")
    _check(all(t.is_cuda and t.device == q.device
               for t in (pool_k, pool_v, table, pos)),
           "every operand must be on q's CUDA device")
    _check(pool_k.is_contiguous() and pool_v.is_contiguous(),
           "the pool must be contiguous (P, psz, Hkv, Dh)")
    # cp.async copies 16-byte pieces of every (page row, h) row
    _check(pool_k.data_ptr() % 16 == 0 and pool_v.data_ptr() % 16 == 0,
           "the pool must be 16-byte aligned")
    q = q.contiguous()
    if q.data_ptr() % 16:         # the kernel reads q rows 16 bytes at a time
        q = q.clone()
    table = table.contiguous()
    # the kernel reads int32 or int64 positions as they come: no cast launch
    if pos.dtype not in (torch.int32, torch.int64):
        pos = pos.to(torch.int32)
    pos = pos.contiguous()
    out = torch.empty((B, Hq * Dh), dtype=q.dtype, device=q.device)
    _fn()(q.data_ptr(), int(q.dtype == torch.bfloat16), pool_k.data_ptr(),
          pool_v.data_ptr(), int(pool_k.dtype == torch.bfloat16),
          table.data_ptr(), pos.data_ptr(), int(pos.dtype == torch.int64),
          out.data_ptr(), B, MAXP, psz, Hq, Hkv, Dh,
          _build.f32_bits(1.0 / Dh ** 0.5), _build.stream())
    paged_decode_attention.launches += 1
    return out


def paged_decode_attention(q: torch.Tensor, pool: torch.Tensor,
                           table: torch.Tensor,
                           pos: torch.Tensor) -> torch.Tensor:
    """q (B, Hq, Dh), pool (2, P, psz, Hkv, Dh) one layer's K/V pool,
    table (B, MAXP) int32, pos (B,): K4 on a CUDA tensor, its plain
    version on a CPU tensor. Returns (B, Hq*Dh) in q's dtype."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, pool[0], pool[1], table, pos)
    if q.is_cuda:
        return paged_attention_cuda(q, pool[0], pool[1], table, pos)
    raise ValueError(f"paged_attention: unsupported device {q.device}")


paged_decode_attention.launches = 0


@functools.cache
def _fn():
    return _build.function("q3_paged_attention", "pippippip" + "i" * 7 + "p")
