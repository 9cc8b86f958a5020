"""K3: the whole talker decode step (csrc/talker_step.cu), replacing the
TPU kernel qwen3_tts_tpu/ops/pallas/talker_step.py ::
talker_decode_step_fused.

Applies to the fused-int8 layer layout of ops/quant.quantize_talker
(qkv_proj / gateup_proj QTensors) and a dense KV cache, 1 <= B <= 8. One
wrapper call computes all layers; the fresh K/V rows come back in f32
and the wrapper scatters them into the cache (in place), as the JAX
wrapper does outside its kernel."""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from qwen3_tts_tpu_torch.ops.kernels import _build
from qwen3_tts_tpu_torch.ops.kernels.common import (
    bf16, lane_sum, pv_valid, qmm, rms_heads, rms_rows, rope, row_dot,
    sigmoid)

MAX_B = 8
NSPLIT = 8        # chunks of positions: blocks of a cluster (TA_NSPLIT)


def _dims(layers: Dict, kv: torch.Tensor):
    qkv_t, o_t, d_t = layers["qkv_proj"], layers["o_proj"], layers["down_proj"]
    L, H, NQKV = qkv_t.q.shape
    Dh = layers["q_norm"].shape[-1]
    QD = o_t.q.shape[1]
    nH, nKV = QD // Dh, (NQKV - QD) // (2 * Dh)
    I = d_t.q.shape[1]
    B, S = kv.shape[2], kv.shape[3]
    return L, H, NQKV, Dh, QD, nH, nKV, I, B, S


def split_attention(q: torch.Tensor, K: torch.Tensor, V: torch.Tensor,
                    pos: torch.Tensor, scale: float) -> torch.Tensor:
    """The attention of K3 in its kernel's order (csrc/talker_step.cu):
    the positions cut into NSPLIT chunks of C = ceil(S / NSPLIT); scores
    s = row_dot(q, K) * scale; M the max over s <= pos; e = exp(s - M);
    each chunk's sum in lane_sum order, the live chunks' sums added in
    chunk order; p = bf16(e / sum); each chunk's P.V chains in position
    order; the live chunks' partials added in chunk order.

    q (B, nKV, G, Dh) bf16 values in f32; K, V (B, S, nKV, Dh) bf16 values
    in f32 with the fresh rows at pos; returns (B, nKV, G, Dh) f32."""
    B, S, nKV, Dh = K.shape
    C = -(-S // NSPLIT)
    pad = (0, 0, 0, NSPLIT * C - S)
    Kh = F.pad(K.permute(0, 2, 1, 3), pad)[:, :, None]   # (B, nKV, 1, 8C, Dh)
    Vh = F.pad(V.permute(0, 2, 1, 3), pad)[:, :, None]
    sc = row_dot(q[:, :, :, None, :], Kh) * scale         # (B, nKV, G, 8C)
    valid = (torch.arange(NSPLIT * C, device=q.device)[None, :]
             <= pos[:, None])[:, None, None, :]            # (B, 1, 1, 8C)
    M = torch.where(valid, sc, torch.full_like(sc, -torch.inf)).amax(
        -1, keepdim=True)
    e = torch.where(valid, torch.exp(sc - M), torch.zeros_like(sc))
    live = (torch.arange(NSPLIT, device=q.device)[None, :]
            <= (pos // C)[:, None])[:, None, None, :]      # (B, 1, 1, 8)
    chunk = lane_sum(e.unflatten(-1, (NSPLIT, C)))         # (B, nKV, G, 8)
    tot = chunk[..., 0]
    for c in range(1, NSPLIT):
        tot = torch.where(live[..., c], tot + chunk[..., c], tot)
    p = bf16(e / tot[..., None])
    part = pv_valid(p.unflatten(-1, (NSPLIT, C)),
                    Vh.unflatten(3, (NSPLIT, C)),
                    valid.unflatten(-1, (NSPLIT, C)))      # (B, nKV, G, 8, Dh)
    out = torch.zeros_like(part[..., 0, :])
    for c in range(NSPLIT):
        out = torch.where(live[..., c, None], out + part[..., c, :], out)
    return out


def talker_step_plain(layers: Dict, x: torch.Tensor, pos: torch.Tensor,
                      kv: torch.Tensor, rope_cos: torch.Tensor,
                      rope_sin: torch.Tensor, eps: float):
    """The kernel's plain PyTorch version, op for op and in the kernel's
    summation order (ops/kernels/common.py, split_attention). Returns (h
    (B, H) through bf16 in x's dtype, fresh rows (L, 2, B, nKV, Dh) f32)."""
    L, H, NQKV, Dh, QD, nH, nKV, I, B, S = _dims(layers, kv)
    G = nH // nKV
    scale = 1.0 / (Dh ** 0.5)
    pos = pos.long()
    b_idx = torch.arange(B, device=x.device)
    c = rope_cos.float()[pos][:, None, :]            # (B, 1, Dh)
    s = rope_sin.float()[pos][:, None, :]
    h = bf16(x.float())
    rows = torch.empty((L, 2, B, nKV, Dh), dtype=torch.float32,
                       device=x.device)
    for l in range(L):
        qkv = qmm(rms_rows(h, layers["input_ln"][l], eps),
                  layers["qkv_proj"].q[l], layers["qkv_proj"].scale[l])
        q = rms_heads(qkv[:, :QD].reshape(B, nH, Dh), layers["q_norm"][l],
                      eps)
        k = rms_heads(qkv[:, QD:QD + nKV * Dh].reshape(B, nKV, Dh),
                      layers["k_norm"][l], eps)
        v = qkv[:, QD + nKV * Dh:].reshape(B, nKV, Dh)
        q, k = rope(q, c, s), rope(k, c, s)
        rows[l, 0], rows[l, 1] = k, v
        K = bf16(kv[l, 0].float())                    # (B, S, nKV, Dh)
        V = bf16(kv[l, 1].float())
        K[b_idx, pos] = bf16(k)
        V[b_idx, pos] = bf16(v)
        attn = split_attention(bf16(q).reshape(B, nKV, G, Dh), K, V, pos,
                               scale)
        attn = bf16(attn).reshape(B, QD)
        h = h + qmm(attn, layers["o_proj"].q[l], layers["o_proj"].scale[l])
        gu = qmm(rms_rows(h, layers["post_ln"][l], eps),
                 layers["gateup_proj"].q[l], layers["gateup_proj"].scale[l])
        g, u = gu[:, :I], gu[:, I:]
        h = h + qmm(g * sigmoid(g) * u, layers["down_proj"].q[l],
                    layers["down_proj"].scale[l])
    return bf16(h).to(x.dtype), rows


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"talker_step: {msg}")


def talker_step_cuda(layers: Dict, x: torch.Tensor, pos: torch.Tensor,
                     kv: torch.Tensor, rope_cos: torch.Tensor,
                     rope_sin: torch.Tensor, eps: float):
    """Launch the kernel; same contract as talker_step_plain. The products
    and the norm weights may be strided views over the layer axis and the
    weight rows (K7 passes the blocks of its merged streams, see
    talker_merged.merged_views); only their rows must be contiguous, and
    the products' rows and the norm weights 16-byte aligned (the kernel
    refuses them otherwise)."""
    L, H, NQKV, Dh, QD, nH, nKV, I, B, S = _dims(layers, kv)
    _check(1 <= B <= MAX_B, f"batch {B} outside 1..{MAX_B}")
    _check(Dh in (8, 16, 32, 64, 128), f"head_dim {Dh}")
    _check(nH % nKV == 0 and nH // nKV <= 8, f"{nH} heads over {nKV}")
    _check(x.dtype in (torch.bfloat16, torch.float32), f"x {x.dtype}")
    _check(kv.dtype in (torch.bfloat16, torch.float32), f"kv {kv.dtype}")
    _check(x.shape == (B, H), f"x shape {tuple(x.shape)}")
    norms = [layers[n] for n in ("input_ln", "post_ln", "q_norm", "k_norm")]
    nw_dtype = norms[0].dtype
    _check(all(n.dtype == nw_dtype for n in norms)
           and nw_dtype in (torch.bfloat16, torch.float32),
           "norm weights must share one dtype, bf16 or f32")
    quants = [layers[n] for n in ("qkv_proj", "o_proj", "gateup_proj",
                                  "down_proj")]
    _check(all(t.q.dtype == torch.int8 and t.scale.dtype == torch.float32
               for t in quants), "products must be int8 with f32 scales")
    _check(all(t.is_cuda and t.is_contiguous()
               for t in (x, kv, rope_cos, rope_sin)),
           "x, kv and the rope tables must be contiguous CUDA tensors")
    _check(all(t.is_cuda and t.stride(-1) == 1
               for t in norms + [a for t in quants for a in (t.q, t.scale)]),
           "weights must be CUDA tensors with contiguous rows")
    _check(rope_cos.dtype == torch.float32 and rope_sin.dtype == torch.float32
           and rope_cos.shape[0] >= S, "rope tables must be f32 (>= S, Dh)")
    dev = x.device
    pos32 = pos.to(torch.int32).contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    h_out = torch.empty((B, H), dtype=x.dtype, device=dev)
    rows = torch.empty((L, 2, B, nKV, Dh), **f32)
    hbuf = torch.empty((B, H), **f32)
    qkv_buf = torch.empty((B, NQKV), **f32)
    attn_buf = torch.empty((B, QD), dtype=torch.bfloat16, device=dev)
    gu_buf = torch.empty((B, 2 * I), **f32)
    _fn()(x.data_ptr(), int(x.dtype == torch.bfloat16), pos32.data_ptr(),
          rope_cos.data_ptr(), rope_sin.data_ptr(),
          *[a for t in quants for a in (t.q.data_ptr(), t.q.stride(0),
                                        t.q.stride(1), t.scale.data_ptr(),
                                        t.scale.stride(0))],
          *[a for n in norms for a in (n.data_ptr(), n.stride(0))],
          int(nw_dtype == torch.bfloat16),
          kv.data_ptr(), int(kv.dtype == torch.bfloat16),
          *[t.data_ptr() for t in (h_out, rows, hbuf, qkv_buf, attn_buf,
                                   gu_buf)],
          L, B, S, H, nH, nKV, Dh, I, _build.f32_bits(eps),
          _build.f32_bits(1.0 / (Dh ** 0.5)), _build.stream())
    return h_out, rows


def talker_decode_step_fused(layers: Dict, x: torch.Tensor,
                             pos: torch.Tensor, kv: torch.Tensor,
                             rope_cos: torch.Tensor, rope_sin: torch.Tensor,
                             *, eps: float) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """One talker decode step over all layers: K3 on a CUDA tensor, its
    plain version on a CPU tensor. Returns (hidden (B, H) pre-final-norm,
    kv with the fresh rows written at pos, in place)."""
    if x.device.type == "cpu":
        h, rows = talker_step_plain(layers, x, pos, kv, rope_cos, rope_sin,
                                    eps)
    elif x.is_cuda:
        h, rows = talker_step_cuda(layers, x, pos, kv, rope_cos, rope_sin,
                                   eps)
        talker_decode_step_fused.launches += 1
    else:
        raise ValueError(f"talker_step: unsupported device {x.device}")
    return h, scatter_rows(kv, pos, rows)


def scatter_rows(kv: torch.Tensor, pos: torch.Tensor,
                 rows: torch.Tensor) -> torch.Tensor:
    """Write the fresh rows (L, 2, B, nKV, Dh) into kv (L, 2, B, S, nKV,
    Dh) at each row's pos, in place; returns kv."""
    b_idx = torch.arange(kv.shape[2], device=kv.device)
    kv[:, :, b_idx, pos.long()] = rows.to(kv.dtype)
    return kv


talker_decode_step_fused.launches = 0


@functools.cache
def _fn():
    return _build.function("q3_talker_step", "pippp" + "plipl" * 4
                           + "pl" * 4 + "ipi" + "p" * 6 + "i" * 10 + "p")
