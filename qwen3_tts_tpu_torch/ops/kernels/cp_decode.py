"""K2: the code predictor's AR steps 1..14 with in-kernel sampling
(csrc/cp_decode.cu), replacing the TPU kernel
qwen3_tts_tpu/ops/pallas/cp_decode.py :: cp_decode_steps (with
topk_keep_mask and sample_tokens).

Applies to int8 code-predictor params (ops/quant.quantize_code_predictor:
separate q/k/v/o/gate/up/down QTensors, QTensor lm_heads), 1 <= B <= 8.
The plain version below holds the kernel's math op for op; its sampling
(topk_keep_mask, sample_tokens, with ops/sampling.gumbel_noise)
reproduces the JAX kernel's integer arithmetic bit for bit, emulating
uint32 with int64 & 0xFFFFFFFF. radix_threshold emulates the kernel's
sampler threshold for the CPU tests."""

from __future__ import annotations

import functools
from typing import Dict

import torch

from qwen3_tts_tpu_torch.ops.kernels import _build
from qwen3_tts_tpu_torch.ops.kernels.common import (
    NEG, bf16, lane_dot, pv, qmm, rms_heads, rms_rows, rope, sigmoid,
    softmax_sum)
from qwen3_tts_tpu_torch.ops.sampling import M32, gumbel_noise

MAX_B = 8
MAX_V = 4096          # SAMPLE_THREADS * SAMPLE_PER in csrc/cp_decode.cu


def topk_keep_mask(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Per-row mask logits >= (k-th largest value), ties kept, found by a
    32-step bitwise search on the order-preserving integer transform of
    the f32 bits. logits (N, V) f32 -> bool (N, V)."""
    bits = logits.float().contiguous().view(torch.int32).long() & M32
    flip = torch.where((bits >> 31) > 0, torch.full_like(bits, M32),
                       torch.full_like(bits, 0x80000000))
    key = bits ^ flip
    thr = torch.zeros((logits.shape[0], 1), dtype=torch.int64,
                      device=logits.device)
    for b in range(32):
        cand = thr | (0x80000000 >> b)
        cnt = (key >= cand).sum(-1, keepdim=True)
        thr = torch.where(cnt >= k, cand, thr)
    return key >= thr


def sort_keys(logits: torch.Tensor) -> torch.Tensor:
    """The order-preserving unsigned transform of the f32 bits (the
    kernel's sort_key), as int64."""
    bits = logits.float().contiguous().view(torch.int32).long() & M32
    return torch.where((bits >> 31) > 0, bits ^ M32, bits ^ 0x80000000)


def radix_threshold(logits: torch.Tensor, k: int) -> torch.Tensor:
    """The sampler kernel's top-k threshold: the k-th largest sort key of
    each row, found as cp_sample_kernel does, by a radix select of 4
    rounds of 8 bits (a 256-bin histogram of the next byte of the keys
    that share the bytes chosen so far, then the largest bin whose suffix
    count reaches the rank left). logits (N, V) f32 -> (N, 1) int64;
    topk_keep_mask keeps exactly key >= this."""
    key = sort_keys(logits)
    N = key.shape[0]
    thr = torch.zeros((N, 1), dtype=torch.int64, device=key.device)
    kk = torch.full((N, 1), k, dtype=torch.int64, device=key.device)
    bins = torch.arange(256, device=key.device)
    for rnd in range(4):
        shift = 24 - 8 * rnd
        hi = (M32 << (shift + 8)) & M32 if rnd else 0
        cand = (key & hi) == thr
        digit = (key >> shift) & 255
        hist = torch.zeros((N, 256), dtype=torch.int64, device=key.device)
        hist.scatter_add_(1, digit, cand.long())
        ge = hist.flip(1).cumsum(1).flip(1)          # count(digit >= d)
        d = torch.where(ge >= kk, bins, -1).amax(1, keepdim=True)
        above = ge.gather(1, d) - hist.gather(1, d)  # count(digit > d)
        thr = thr | (d << shift)
        kk = kk - above
    return thr


def sample_tokens(logits: torch.Tensor, seed_col: torch.Tensor, step: int,
                  *, top_k: int, temperature: float,
                  greedy: bool) -> torch.Tensor:
    """Top-k keep set, counter-based hash PRNG, Gumbel-max over the kept,
    scaled logits (a categorical draw over the top-k softmax); greedy is
    the first-index argmax. logits (N, V) f32; seed_col (N, 1) int32
    per-row seeds; step: the AR step index. Returns (N, 1) int32."""
    N, V = logits.shape
    logits = logits.float()
    iota = torch.arange(V, device=logits.device, dtype=torch.int64)
    if greedy:
        z = logits
    else:
        keep = topk_keep_mask(logits, top_k)
        masked = torch.where(keep, logits, torch.full_like(logits, NEG))
        gumbel = gumbel_noise(seed_col, step, V)
        z = torch.where(keep, masked * (1.0 / max(temperature, 1e-6))
                        + gumbel, torch.full_like(logits, NEG))
    zm = z.amax(-1, keepdim=True)
    idx = torch.where(z == zm, iota[None, :], torch.full_like(iota, V))
    return idx.amin(-1, keepdim=True).to(torch.int32)


def _dims(params: Dict, kv: torch.Tensor):
    layers = params["layers"]
    L, H, QD = layers["q_proj"].q.shape
    KVD = layers["k_proj"].q.shape[-1]
    Dh = layers["q_norm"].shape[-1]
    I = layers["gate_proj"].q.shape[-1]
    G1, V, _ = params["codec_embs"].shape
    B, S = kv.shape[2], kv.shape[3]
    return L, H, QD, KVD, Dh, QD // Dh, KVD // Dh, I, V, G1 - 1, B, S


def cp_decode_plain(params: Dict, tok0: torch.Tensor, kv: torch.Tensor,
                    rope_cos: torch.Tensor, rope_sin: torch.Tensor,
                    seeds: torch.Tensor, *, eps: float, top_k: int,
                    temperature: float, greedy: bool, scratch: bool = False):
    """The kernel's plain PyTorch version, op for op and in the kernel's
    summation order (ops/kernels/common.py). tok0, seeds (B,) int;
    kv (L, 2, B, S, nKV, Dh) post-prefill. Returns (14, B) int32; with
    ``scratch``, also the last step's logits (B, V) f32 and residual row
    (B, H) bf16 (the kernel's ``logits`` and ``xbuf``)."""
    L, H, QD, KVD, Dh, nH, nKV, I, V, n_steps, B, S = _dims(params, kv)
    G = nH // nKV
    scale = 1.0 / (Dh ** 0.5)
    layers, heads = params["layers"], params["lm_heads"]
    embs = params["codec_embs"]
    kvf = kv.float().clone()
    tok = tok0.long().reshape(B)
    seed_col = seeds.to(torch.int32).reshape(B, 1)
    out = torch.empty((n_steps, B), dtype=torch.int32, device=kv.device)
    for i in range(n_steps):
        p = i + 2
        c, s = rope_cos[p].float(), rope_sin[p].float()
        valid = torch.arange(S, device=kv.device) <= p
        x = bf16(qmm(embs[i][tok], params["mtp_proj_w"])
                 + params["mtp_proj_b"].float())
        for l in range(L):
            def proj(name, inp):
                return qmm(inp, layers[name].q[l], layers[name].scale[l])
            hn = rms_rows(x, layers["input_ln"][l], eps)
            q = rms_heads(proj("q_proj", hn).reshape(B, nH, Dh),
                          layers["q_norm"][l], eps)
            k = rms_heads(proj("k_proj", hn).reshape(B, nKV, Dh),
                          layers["k_norm"][l], eps)
            v = proj("v_proj", hn).reshape(B, nKV, Dh)
            q, k = rope(q, c, s), rope(k, c, s)
            kvf[l, 0, :, p], kvf[l, 1, :, p] = k, v
            Kh = kvf[l, 0].permute(0, 2, 1, 3)[:, :, None]  # (B,nKV,1,S,Dh)
            sc = lane_dot(q.reshape(B, nKV, G, 1, Dh), Kh) * scale
            sc = torch.where(valid, sc, torch.full_like(sc, NEG))
            e = torch.exp(sc - sc.amax(-1, keepdim=True))
            e = torch.where(valid, e, torch.zeros_like(e))
            pb = e / softmax_sum(e)[..., None]
            Vh = kvf[l, 1].permute(0, 2, 1, 3)[:, :, None]
            attn = pv(pb, Vh, p + 1).reshape(B, QD)
            x = bf16(x + bf16(proj("o_proj", attn)))
            hn = rms_rows(x, layers["post_ln"][l], eps)
            g, u = proj("gate_proj", hn), proj("up_proj", hn)
            x = bf16(x + bf16(proj("down_proj", g * sigmoid(g) * u)))
        logits = qmm(rms_rows(x, params["final_norm"], eps), heads.q[i + 1],
                     heads.scale[i + 1])
        tok = sample_tokens(logits, seed_col, i, top_k=top_k,
                            temperature=temperature, greedy=greedy)[:, 0]
        out[i] = tok
        tok = tok.long()
    if scratch:
        return out, logits, x.to(torch.bfloat16)
    return out


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"cp_decode: {msg}")


def _flag(t: torch.Tensor, what: str) -> int:
    _check(t.dtype in (torch.bfloat16, torch.float32),
           f"{what} must be bf16 or f32, got {t.dtype}")
    return int(t.dtype == torch.bfloat16)


def cp_decode_cuda(params: Dict, tok0: torch.Tensor, kv: torch.Tensor,
                   rope_cos: torch.Tensor, rope_sin: torch.Tensor,
                   seeds: torch.Tensor, *, eps: float, top_k: int,
                   temperature: float, greedy: bool, scratch: bool = False):
    """Launch K2; same contract as cp_decode_plain (``scratch``: also its
    ``logits`` and ``xbuf`` buffers after the last step)."""
    L, H, QD, KVD, Dh, nH, nKV, I, V, n_steps, B, S = _dims(params, kv)
    _check(1 <= B <= MAX_B, f"batch {B} outside 1..{MAX_B}")
    _check(Dh <= 128 and Dh % 2 == 0, f"head_dim {Dh}")
    _check(n_steps + 2 <= S, f"{n_steps} steps need S >= {n_steps + 2}")
    _check(0 < top_k <= V, f"top_k {top_k}")
    _check(V <= MAX_V, f"group vocab {V} > {MAX_V}")
    layers, heads = params["layers"], params["lm_heads"]
    qnames = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
              "up_proj", "down_proj")
    norms = [layers[n] for n in ("input_ln", "post_ln", "q_norm", "k_norm")]
    norms.append(params["final_norm"])
    nw = _flag(norms[0], "norm weights")
    _check(all(n.dtype == norms[0].dtype for n in norms),
           "norm weights must share one dtype")
    mtp_w, mtp_b = params["mtp_proj_w"], params["mtp_proj_b"]
    mtp = _flag(mtp_w, "mtp_proj_w")
    _check(mtp_b.dtype == mtp_w.dtype, "mtp_proj_b dtype != mtp_proj_w")
    embs = params["codec_embs"]
    tensors = ([kv, rope_cos, rope_sin, mtp_w, mtp_b, embs, heads.q,
                heads.scale] + norms
               + [a for n in qnames for a in (layers[n].q, layers[n].scale)])
    _check(all(t.is_cuda and t.is_contiguous() for t in tensors),
           "every operand must be a contiguous CUDA tensor")
    _check(rope_cos.dtype == torch.float32 and rope_sin.dtype == torch.float32,
           "rope tables must be f32")
    dev = kv.device
    tok0 = tok0.to(torch.int32).reshape(B).contiguous()
    seeds = seeds.to(torch.int32).reshape(B).contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    out = torch.empty((n_steps, B), dtype=torch.int32, device=dev)
    kvbuf = torch.empty(kv.shape, **f32)
    xbuf = torch.empty((B, H), dtype=torch.bfloat16, device=dev)
    q_buf = torch.empty((B, QD), **f32)
    k_buf = torch.empty((B, KVD), **f32)
    v_buf = torch.empty((B, KVD), **f32)
    attn_buf = torch.empty((B, QD), dtype=torch.bfloat16, device=dev)
    gu_buf = torch.empty((B, 2 * I), **f32)
    logits = torch.empty((B, V), **f32)
    tok_cur = torch.empty((B,), dtype=torch.int32, device=dev)
    _fn()(*[t.data_ptr() for t in (tok0, seeds, rope_cos, rope_sin)],
          *[t.data_ptr() for n in qnames
            for t in (layers[n].q, layers[n].scale)],
          *[t.data_ptr() for t in norms], nw,
          mtp_w.data_ptr(), mtp_b.data_ptr(), mtp,
          embs.data_ptr(), _flag(embs, "codec_embs"),
          heads.q.data_ptr(), heads.scale.data_ptr(),
          kv.data_ptr(), _flag(kv, "kv"),
          *[t.data_ptr() for t in (out, kvbuf, xbuf, q_buf, k_buf, v_buf,
                                   attn_buf, gu_buf, logits, tok_cur)],
          L, B, S, H, nH, nKV, Dh, I, V, n_steps, top_k, int(greedy),
          _build.f32_bits(1.0 / max(temperature, 1e-6)),
          _build.f32_bits(eps), _build.f32_bits(1.0 / (Dh ** 0.5)),
          _build.stream())
    cp_decode_steps.launches += 1
    if scratch:
        return out, logits, xbuf
    return out


def qsplit(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor, *,
           norm: torch.Tensor = None, eps: float = 1e-6,
           residual: torch.Tensor = None) -> torch.Tensor:
    """The cluster-split product of K2 and K3 alone on CUDA tensors: f32
    (R, N) = qmm(x, w, s) for x (R, K) bf16 or f32 and w (K, N) int8, its
    k-slice groups split over clusters of 2, 4 or 8 blocks as a step's
    product of that width (csrc/common.cuh qsplit). w may be a column
    block of a wider matrix (rows contiguous, read with their row stride).
    With ``norm`` (K,) the rows are RMS-normed first, qmm(rms_rows(x, norm,
    eps), w, s); with ``residual`` (R, N) f32 the result is residual +
    qmm(x, w, s) (not both). Its plain emulation on the CPU is
    ops/kernels/common.qmm_split."""
    R, K = x.shape
    N = w.shape[1]
    _check(x.is_cuda and w.is_cuda and s.is_cuda, "qsplit: CUDA tensors")
    _check(w.dtype == torch.int8 and s.dtype == torch.float32,
           "qsplit: int8 weight, f32 scales")
    _check(1 <= R <= MAX_B, f"qsplit: R {R}")
    _check(w.shape[0] == K and tuple(s.shape) == (N,) and w.stride(1) == 1,
           f"qsplit: x {tuple(x.shape)}, w {tuple(w.shape)} (stride "
           f"{w.stride()}), s {tuple(s.shape)}")
    _check(norm is None or residual is None, "qsplit: norm or residual")
    x, s = x.contiguous(), s.contiguous()
    if residual is None:
        out = torch.empty((R, N), dtype=torch.float32, device=x.device)
    else:
        _check(residual.dtype == torch.float32
               and tuple(residual.shape) == (R, N), "qsplit: residual")
        out = residual.contiguous().clone()
    nw = None if norm is None else norm.contiguous()
    _qsplit_fn()(x.data_ptr(), _flag(x, "x"),
                 None if nw is None else nw.data_ptr(),
                 0 if nw is None else _flag(nw, "norm"), w.data_ptr(),
                 w.stride(0), s.data_ptr(), out.data_ptr(),
                 int(residual is not None), R, K, N, _build.f32_bits(eps),
                 _build.stream())
    qsplit.launches += 1
    return out


qsplit.launches = 0


def cp_decode_steps(params: Dict, tok0: torch.Tensor, kv: torch.Tensor,
                    rope_cos: torch.Tensor, rope_sin: torch.Tensor,
                    seeds: torch.Tensor, *, eps: float, top_k: int,
                    temperature: float, greedy: bool) -> torch.Tensor:
    """CP AR steps 1..14: K2 on a CUDA tensor, its plain version on a CPU
    tensor. Returns (14, B) int32 (codec groups 2..15)."""
    fn = {"cpu": cp_decode_plain, "cuda": cp_decode_cuda}.get(kv.device.type)
    if fn is None:
        raise ValueError(f"cp_decode: unsupported device {kv.device}")
    return fn(params, tok0, kv, rope_cos, rope_sin, seeds, eps=eps,
              top_k=top_k, temperature=temperature, greedy=greedy)


cp_decode_steps.launches = 0


@functools.cache
def _fn():
    return _build.function(
        "q3_cp_decode", "pppp" + "p" * 14 + "ppppp" + "i" + "ppi" + "pi"
        + "pp" + "pi" + "p" + "p" * 9 + "i" * 15 + "p")


@functools.cache
def _qsplit_fn():
    return _build.function("q3_qsplit", "pipipippiiiiip")
