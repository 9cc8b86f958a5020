"""Qwen3 transformer blocks shared by the talker and the code predictor.
Twin of qwen3_tts_tpu/models/transformer.py.

Weights are stacked along a leading layer axis and stored (in, out), so
the hot path is ``x @ W``; int8 weights are ops/quant.QTensor and their
products go to K1. Two KV layouts, the JAX ones: the dense cache (L, 2,
B, S, Hkv, Dh), whose decode attention is plain torch ops or K5
(``attention_impl="pallas"``), and the block-paged ``PagedKV``, whose
decode attention is K4. Unlike JAX, the prefill and decode functions
write the new K/V rows into the cache or pool they are given IN PLACE
(and return it), which saves a copy of the cache per step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from qwen3_tts_tpu_torch.ops import quant
from qwen3_tts_tpu_torch.ops.kernels.decode_attention import decode_attention
from qwen3_tts_tpu_torch.ops.kernels.paged_attention import (
    paged_decode_attention)

NEG_MASK = -1e30


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float) -> torch.Tensor:
    """HF Qwen3RMSNorm order: normalise in f32, cast back to the input
    dtype, then multiply by the weight in that dtype."""
    dtype = x.dtype
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    x_hat = (xf * torch.rsqrt(var + eps)).to(dtype)
    return x_hat * weight.to(dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                 dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin of shape positions.shape + (head_dim,), HF rotate_half
    convention (the two halves repeat the same frequencies)."""
    half = head_dim // 2
    freq_idx = torch.arange(half, dtype=torch.float32,
                            device=positions.device)
    inv_freq = 1.0 / (theta ** (freq_idx / half))
    angles = positions.float()[..., None] * inv_freq
    cos = torch.cat([torch.cos(angles)] * 2, dim=-1).to(dtype)
    sin = torch.cat([torch.sin(angles)] * 2, dim=-1).to(dtype)
    return cos, sin


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., heads, head_dim); cos/sin broadcastable to it."""
    xf = x.float()
    return (xf * cos + rotate_half(xf) * sin).to(x.dtype)


def swiglu_mlp(x: torch.Tensor, gate_w, up_w, down_w,
               gateup_w=None) -> torch.Tensor:
    """down(silu(x @ gate) * (x @ up)); a fused gate|up weight runs as
    one product, int8 gate and up weights as one group."""
    if gateup_w is not None:
        gu = quant.matmul(x, gateup_w)
        inter = gu.shape[-1] // 2
        g, u = gu[..., :inter], gu[..., inter:]
    else:
        g, u = quant.matmul_group(x, [gate_w, up_w])
    h = (silu(g) * u).to(x.dtype)
    return quant.matmul(h, down_w).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class TransformerGeometry:
    num_layers: int
    hidden_size: int
    intermediate_size: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rms_norm_eps: float
    rope_theta: float
    attn_impl: str = "xla"  # "xla" | "pallas" (K5 decode attention)

    @property
    def q_groups(self) -> int:
        return self.num_heads // self.num_kv_heads


def geometry_of(cfg) -> TransformerGeometry:
    """The shared geometry of a TalkerConfig / CodePredictorConfig."""
    return TransformerGeometry(
        num_layers=cfg.num_layers, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
        rms_norm_eps=cfg.rms_norm_eps, rope_theta=cfg.rope_theta,
        attn_impl=cfg.attention_impl)


def init_kv_cache(geo: TransformerGeometry, batch: int, max_seq: int,
                  dtype=torch.float32, device=None) -> torch.Tensor:
    """Dense KV cache (L, 2, B, S, Hkv, Dh)."""
    return torch.zeros((geo.num_layers, 2, batch, max_seq,
                        geo.num_kv_heads, geo.head_dim),
                       dtype=dtype, device=device)


def _qkv(layer: dict, x: torch.Tensor, geo: TransformerGeometry,
         cos: torch.Tensor, sin: torch.Tensor):
    """Project, per-head QK-RMSNorm, then RoPE (HF Qwen3Attention order).
    x: (B, T, H); cos/sin: (B, T, Dh). Returns q (B, T, Hq, Dh), k/v
    (B, T, Hkv, Dh)."""
    B, T, _ = x.shape
    xf = x.reshape(B * T, -1)
    QD = geo.num_heads * geo.head_dim
    KVD = geo.num_kv_heads * geo.head_dim
    if "qkv_proj" in layer:
        qkv = quant.matmul(xf, layer["qkv_proj"])
        q, k, v = qkv[:, :QD], qkv[:, QD:QD + KVD], qkv[:, QD + KVD:]
    else:
        q, k, v = quant.matmul_group(
            xf, [layer["q_proj"], layer["k_proj"], layer["v_proj"]])
    q = q.to(x.dtype).reshape(B, T, geo.num_heads, geo.head_dim)
    k = k.to(x.dtype).reshape(B, T, geo.num_kv_heads, geo.head_dim)
    v = v.to(x.dtype).reshape(B, T, geo.num_kv_heads, geo.head_dim)
    q = rms_norm(q, layer["q_norm"], geo.rms_norm_eps)
    k = rms_norm(k, layer["k_norm"], geo.rms_norm_eps)
    q = apply_rope(q, cos[:, :, None, :], sin[:, :, None, :])
    k = apply_rope(k, cos[:, :, None, :], sin[:, :, None, :])
    return q, k, v


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: torch.Tensor, geo: TransformerGeometry):
    """q (B, Tq, Hq, Dh); k/v (B, Tk, Hkv, Dh); mask (B, Tq, Tk) bool,
    True = attend. Scores and softmax in f32. Returns (B, Tq, Hq*Dh)."""
    B, Tq = q.shape[0], q.shape[1]
    G = geo.q_groups
    qg = q.reshape(B, Tq, geo.num_kv_heads, G, geo.head_dim)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    scores = scores / math.sqrt(geo.head_dim)
    scores = torch.where(mask[:, None, None], scores,
                         torch.full_like(scores, NEG_MASK))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.float(),
                       v.float()).to(v.dtype)
    return out.reshape(B, Tq, geo.num_heads * geo.head_dim)


def _block(layer: dict, h: torch.Tensor, geo: TransformerGeometry,
           cos, sin, attend):
    """One pre-norm transformer layer; ``attend(q, k, v)`` returns the
    attention output (B, T, Hq*Dh) and stores K/V where it belongs."""
    hn = rms_norm(h, layer["input_ln"], geo.rms_norm_eps)
    q, k, v = _qkv(layer, hn, geo, cos, sin)
    attn = attend(q, k, v)
    B, T = attn.shape[0], attn.shape[1]
    attn = quant.matmul(attn.reshape(B * T, -1),
                        layer["o_proj"]).reshape(B, T, -1).to(h.dtype)
    h = h + attn
    hn = rms_norm(h, layer["post_ln"], geo.rms_norm_eps)
    return h + swiglu_mlp(hn, layer.get("gate_proj"), layer.get("up_proj"),
                          layer["down_proj"],
                          gateup_w=layer.get("gateup_proj"))


def forward_prefill_unrolled(layers_list, x: torch.Tensor,
                             positions: torch.Tensor,
                             attn_mask: torch.Tensor,
                             geo: TransformerGeometry,
                             kv_cache: Optional[torch.Tensor] = None):
    """All layers over a full (padded) sequence x (B, P, H); K/V land in
    kv_cache[:, :, :, :P] (in place). Returns (hidden before the final
    norm, kv_cache)."""
    cos, sin = rope_cos_sin(positions, geo.head_dim, geo.rope_theta)
    P = x.shape[1]
    h = x
    for li, layer in enumerate(layers_list):
        def attend(q, k, v, li=li):
            if kv_cache is not None:
                kv_cache[li, 0, :, :P] = k.to(kv_cache.dtype)
                kv_cache[li, 1, :, :P] = v.to(kv_cache.dtype)
            return gqa_attention(q, k, v, attn_mask, geo)
        h = _block(layer, h, geo, cos, sin, attend)
    return h, kv_cache


def _layers(params: dict):
    L = params["input_ln"].shape[0]
    return [{k: v[l] for k, v in params.items()} for l in range(L)]


def forward_prefill(params: dict, x: torch.Tensor, positions: torch.Tensor,
                    attn_mask: torch.Tensor, geo: TransformerGeometry,
                    kv_cache: Optional[torch.Tensor] = None):
    """forward_prefill_unrolled over a stacked layer dict."""
    return forward_prefill_unrolled(_layers(params), x, positions,
                                    attn_mask, geo, kv_cache)


def causal_mask(batch: int, seq_len: int, lengths: torch.Tensor):
    """(B, P, P) bool: causal AND key position < length."""
    idx = torch.arange(seq_len, device=lengths.device)
    causal = idx[None, :] <= idx[:, None]
    valid = idx[None, :] < lengths[:, None]
    return causal[None] & valid[:, None, :]


def decode_step(params: dict, x: torch.Tensor, pos: torch.Tensor,
                kv_cache: torch.Tensor, geo: TransformerGeometry):
    """One token per row over all layers: x (B, H), pos (B,) write
    positions. The new K/V rows go into kv_cache in place. Attention is
    K5 when ``geo.attn_impl == "pallas"``, plain torch ops otherwise.
    Returns (hidden (B, H) before the final norm, kv_cache)."""
    B = x.shape[0]
    S = kv_cache.shape[3]
    cos, sin = rope_cos_sin(pos[:, None], geo.head_dim, geo.rope_theta)
    mask = (torch.arange(S, device=x.device)[None, :]
            <= pos[:, None])[:, None, :]
    b_idx = torch.arange(B, device=x.device)
    h = x[:, None, :]
    for li, layer in enumerate(_layers(params)):
        def attend(q, k, v, li=li):
            kv_cache[li, 0, b_idx, pos] = k[:, 0].to(kv_cache.dtype)
            kv_cache[li, 1, b_idx, pos] = v[:, 0].to(kv_cache.dtype)
            if geo.attn_impl == "pallas":
                return decode_attention(q[:, 0], kv_cache[li, 0],
                                        kv_cache[li, 1], pos)[:, None]
            return gqa_attention(q, kv_cache[li, 0], kv_cache[li, 1],
                                 mask, geo)
        h = _block(layer, h, geo, cos, sin, attend)
    return h[:, 0], kv_cache


# ---------------------------------------------------------------------------
# Block-paged KV cache
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PagedKV:
    """Block-paged KV: rows own pages of a shared pool via a page table,
    so memory tracks use instead of B x worst case, and a row's length is
    bounded by its allocated pages (grown by the batcher between decode
    chunks), not by a dense allocation.

    pool:     (L, 2, P, page_size, Hkv, Dh)
    table:    (B, MAXP) int32, page ids in logical order; entries past
              the allocation are 0, a reserved page only ever read masked
    capacity: (B,) int32 allocated rows (pages x page_size)
    """

    pool: torch.Tensor
    table: torch.Tensor
    capacity: torch.Tensor

    @property
    def page_size(self) -> int:
        return self.pool.shape[3]


def init_paged_kv(geo: TransformerGeometry, batch: int, n_pages: int,
                  page_size: int, max_pages_per_slot: int,
                  dtype=torch.float32, device=None) -> PagedKV:
    i32 = dict(dtype=torch.int32, device=device)
    return PagedKV(
        pool=torch.zeros((geo.num_layers, 2, n_pages, page_size,
                          geo.num_kv_heads, geo.head_dim), dtype=dtype,
                         device=device),
        table=torch.zeros((batch, max_pages_per_slot), **i32),
        capacity=torch.zeros((batch,), **i32))


def kv_capacity(kv):
    """Rows a row may occupy: (B,) per row for paged, the dense S
    otherwise."""
    if isinstance(kv, PagedKV):
        return kv.capacity
    return kv.shape[3]


def paged_scatter_rows(paged: PagedKV, slot: int, rows_kv: torch.Tensor,
                       start: int = 0) -> PagedKV:
    """Write rows_kv (L, 2, R, Hkv, Dh) into logical rows [start,
    start + R) of ``slot`` (in place): splices a dense batch-1 prefill
    into the slot's pages."""
    R = rows_kv.shape[2]
    psz = paged.page_size
    logical = start + torch.arange(R, device=paged.table.device)
    pages = paged.table[slot, logical // psz].long()
    paged.pool[:, :, pages, logical % psz] = rows_kv.to(paged.pool.dtype)
    return paged


def paged_decode_step(params: dict, x: torch.Tensor, pos: torch.Tensor,
                      paged: PagedKV, geo: TransformerGeometry):
    """decode_step against the paged pool: row b's new K/V land at page
    table[b, pos // psz], row pos % psz (in place), then attention over
    the row's pages runs on K4. Returns (hidden (B, H) before the final
    norm, paged)."""
    B = x.shape[0]
    psz = paged.page_size
    cos, sin = rope_cos_sin(pos[:, None], geo.head_dim, geo.rope_theta)
    b_idx = torch.arange(B, device=x.device)
    page_ids = paged.table[b_idx, pos // psz].long()
    rows = pos % psz
    h = x[:, None, :]
    for li, layer in enumerate(_layers(params)):
        def attend(q, k, v, li=li):
            pool_l = paged.pool[li]
            pool_l[0, page_ids, rows] = k[:, 0].to(pool_l.dtype)
            pool_l[1, page_ids, rows] = v[:, 0].to(pool_l.dtype)
            return paged_decode_attention(q[:, 0], pool_l, paged.table,
                                          pos)[:, None]
        h = _block(layer, h, geo, cos, sin, attend)
    return h[:, 0], paged
