"""FP32 codec decoder (vocoder): (B, T, 16) int codes -> 24 kHz waveform.
Twin of qwen3_tts_tpu/models/vocoder.py.

codes -> per-quantizer embedding, mean over 16 -> sliding-window causal
pre-transformer -> 2 ConvNeXt upsampling stages -> causal conv ->
4 x [SnakeBeta, causal transposed conv, 3 residual units (d = 1, 3, 9)]
-> SnakeBeta -> causal conv to 1 channel -> clamp to [-1, 1].

FP32 by contract: ``decode`` runs with TF32 off for both convolutions
and matmuls. Activations are (B, T, C) at every public function, and the
weights keep the JAX layouts: convolutions WIO (K, Cin/groups, Cout),
transposed convolutions pre-flipped WIO. The conv functions convert to
PyTorch's layouts internally.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from qwen3_tts_tpu_torch.config import (
    SAMPLES_PER_TOKEN,
    VOC_CHUNK_SIZE,
    VOC_OVERLAP,
    VocoderConfig,
)
from qwen3_tts_tpu_torch.models import transformer as tfm
from qwen3_tts_tpu_torch.models.module import WeightTree
from qwen3_tts_tpu_torch.utils import profiling

# fixed vocoder window buckets (tokens)
VOC_BUCKETS = (64, 128, 192, 256, 320)


class Vocoder(WeightTree):
    """The vocoder's weights (JAX names and layouts), all f32."""

    def __init__(self, cfg: VocoderConfig, params: dict):
        super().__init__(params)
        self.cfg = cfg


def snake_beta(x: torch.Tensor, alpha: torch.Tensor,
               beta: torch.Tensor) -> torch.Tensor:
    """x + sin^2(x * e^alpha) / (e^beta + 1e-9); x (B, T, C)."""
    s = torch.sin(x * torch.exp(alpha))
    return x + s * s / (torch.exp(beta) + 1e-9)


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                  stride: int = 1, dilation: int = 1,
                  groups: int = 1) -> torch.Tensor:
    """Causal conv (left pad k_eff - stride, right pad to whole frames).
    x (B, T, Cin); w WIO (K, Cin/groups, Cout)."""
    k_eff = (w.shape[0] - 1) * dilation + 1
    pad_l = k_eff - stride
    length = x.shape[1]
    n_frames = (length - k_eff + pad_l) / stride + 1
    pad_r = (math.ceil(n_frames) - 1) * stride + (k_eff - pad_l) - length
    xt = F.pad(x.transpose(1, 2), (pad_l, pad_r))
    out = F.conv1d(xt, w.permute(2, 1, 0), b, stride=stride,
                   dilation=dilation, groups=groups)
    return out.transpose(1, 2)


def causal_trans_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        *, stride: int) -> torch.Tensor:
    """ConvTranspose1d(k, s) cropped by k - s on both sides. ``w`` is the
    JAX pre-flipped WIO (K, Cin, Cout); PyTorch's (Cin, Cout, K) is its
    spatial flip. Output length (T - 1) * s + k - 2 * crop."""
    k = w.shape[0]
    crop = max(k - stride, 0)
    wt = torch.flip(w, dims=(0,)).permute(1, 2, 0)
    out = F.conv_transpose1d(x.transpose(1, 2), wt, b, stride=stride)
    if crop:
        out = out[:, :, crop:out.shape[2] - crop]
    return out.transpose(1, 2)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def pre_transformer(p: dict, x: torch.Tensor,
                    cfg: VocoderConfig) -> torch.Tensor:
    """x (B, T, H) f32 -> (B, T, H): sliding-window causal attention
    (RoPE, LayerScale, RMSNorm, SwiGLU), then the final RMSNorm."""
    B, T, H = x.shape
    Hh, Dh = cfg.num_attention_heads, cfg.head_dim
    i = torch.arange(T, device=x.device)
    mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :]
                                         < cfg.sliding_window)
    cos, sin = tfm.rope_cos_sin(i, Dh, cfg.rope_theta)
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    eps = cfg.rms_norm_eps
    layers = p["layers"]
    for l in range(layers["input_ln"].shape[0]):
        lp = {k: v[l] for k, v in layers.items()}
        hn = tfm.rms_norm(x, lp["input_ln"], eps)
        q = tfm.apply_rope((hn @ lp["q_proj"]).reshape(B, T, Hh, Dh), cos, sin)
        k = tfm.apply_rope((hn @ lp["k_proj"]).reshape(B, T, Hh, Dh), cos, sin)
        v = (hn @ lp["v_proj"]).reshape(B, T, Hh, Dh)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * Dh ** -0.5
        logits = logits.masked_fill(~mask, -float("inf"))
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1), v)
        x = x + lp["attn_scale"] * (o.reshape(B, T, H) @ lp["o_proj"])
        hn = tfm.rms_norm(x, lp["post_ln"], eps)
        m = (F.silu(hn @ lp["gate_proj"]) * (hn @ lp["up_proj"])) \
            @ lp["down_proj"]
        x = x + lp["mlp_scale"] * m
    return tfm.rms_norm(x, p["norm"], eps)


def convnext_block(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Causal depthwise k7, LayerNorm (eps 1e-6), pointwise MLP with exact
    GELU, gamma scale, residual. x (B, T, C)."""
    h = causal_conv1d(x, p["cn_dw_w"], p["cn_dw_b"], groups=x.shape[-1])
    h = layer_norm(h, p["cn_ln_w"], p["cn_ln_b"], 1e-6)
    h = F.gelu(h @ p["cn_pw1_w"] + p["cn_pw1_b"], approximate="none")
    h = h @ p["cn_pw2_w"] + p["cn_pw2_b"]
    return x + p["cn_gamma"] * h


def residual_unit(p: dict, x: torch.Tensor, dilation: int) -> torch.Tensor:
    h = snake_beta(x, p["alpha1"], p["beta1"])
    h = causal_conv1d(h, p["conv1_w"], p["conv1_b"], dilation=dilation)
    h = snake_beta(h, p["alpha2"], p["beta2"])
    h = causal_conv1d(h, p["conv2_w"], p["conv2_b"])
    return x + h


def decoder_block(p: dict, x: torch.Tensor, rate: int) -> torch.Tensor:
    h = snake_beta(x, p["alpha"], p["beta"])
    h = causal_trans_conv1d(h, p["up_w"], p["up_b"], stride=rate)
    for d_i, dil in enumerate((1, 3, 9)):
        h = residual_unit(p["res"][str(d_i)], h, dil)
    return h


@contextlib.contextmanager
def _fp32_exact():
    """TF32 off for convolutions and matmuls (restored on exit)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def decode_raw(params: dict, codes: torch.Tensor,
               cfg: VocoderConfig) -> torch.Tensor:
    """codes (B, T, 16) -> waveform (B, T * 1920 - output_crop) f32."""
    with _fp32_exact():
        codes = codes.long()
        NQ = codes.shape[-1]
        offsets = torch.arange(NQ, device=codes.device) * cfg.codebook_size
        x = params["code_embedding"][codes + offsets].float().mean(dim=2)
        x = pre_transformer(params["pre"], x, cfg)
        for i, f in enumerate(cfg.upsampling_ratios):
            up = params["upsample"][str(i)]
            x = causal_trans_conv1d(x, up["up_w"], up["up_b"], stride=f)
            x = convnext_block(up, x)
        x = causal_conv1d(x, params["dec_in_w"], params["dec_in_b"])
        for i, r in enumerate(cfg.upsample_rates):
            x = decoder_block(params["blocks"][str(i)], x, r)
        x = snake_beta(x, params["out_alpha"], params["out_beta"])
        x = causal_conv1d(x, params["out_w"], params["out_b"])
        return torch.clamp(x[:, :, 0], -1.0, 1.0)


def decode(params: dict, codes: torch.Tensor,
           cfg: VocoderConfig) -> torch.Tensor:
    """codes (B, T, 16) -> (B, T * 1920) f32: the raw decode zero-padded
    to the advertised length."""
    wav = decode_raw(params, codes, cfg)
    pad = codes.shape[1] * cfg.total_upsample - wav.shape[1]
    return F.pad(wav, (0, pad)) if pad > 0 else wav


def voc_bucket(w: int) -> int:
    """Smallest vocoder-window bucket >= w (64-aligned beyond the table)."""
    for b in VOC_BUCKETS:
        if w <= b:
            return b
    return -(-w // 64) * 64


def pad_codes(codes: torch.Tensor, W: int) -> torch.Tensor:
    """Slice or zero-pad (..., T, 16) codes to a W-token window."""
    T = codes.shape[-2]
    if W <= T:
        return codes[..., :W, :]
    return F.pad(codes, (0, 0, 0, W - T))


def int16_decoder(params: dict, cfg: VocoderConfig):
    """The decode_fn of synthesize_exact: (1, W, 16)
    int32 codes on the device -> (1, W * 1920) int16 on the device."""
    return lambda codes: to_int16_device(decode(params, codes, cfg))


def pad_window(codes: np.ndarray, W: int, device) -> torch.Tensor:
    """Host codes (m, 16) sliced or zero-padded to a (1, W, 16) int32
    window on ``device`` (pad_codes)."""
    t = torch.from_numpy(np.ascontiguousarray(codes[:, :16], np.int32))
    return pad_codes(t, W)[None].to(device)


def synthesize_exact(decode_fn, codes: np.ndarray, max_single: int = 256,
                     device="cuda") -> np.ndarray:
    """The decode of every non-streaming path: up to ``max_single`` tokens
    in ONE window of voc_bucket(n + 1) tokens (full attention context;
    the bucket is larger than n, so the last token has a zero-code
    lookahead token), longer utterances through left-context chunking.

    ``decode_fn`` takes (1, W, 16) int32 on ``device`` and returns (1,
    W * 1920) samples there (f32, or int16 from int16_decoder). The n == 0
    early exit returns an empty f32 array whatever decode_fn returns. The
    fetch, which waits for the device, is the span ``vocode_read``."""
    n = len(codes)
    if n == 0:
        return np.zeros((0,), np.float32)
    if n <= max_single:
        out = decode_fn(pad_window(codes, voc_bucket(n + 1), device))
        with profiling.span("vocode_read"):
            return out[0, :n * SAMPLES_PER_TOKEN].cpu().numpy()
    return synthesize_chunked_context(decode_fn, codes, VOC_CHUNK_SIZE,
                                      device=device)


def synthesize_chunked_context(decode_fn, codes: np.ndarray,
                               chunk_tokens: int = VOC_CHUNK_SIZE,
                               context_tokens: int = 25,
                               device="cuda") -> np.ndarray:
    """Left-context + one-token-lookahead chunking. Each chunk re-decodes
    ``context_tokens`` of left context (discarded) and one token of
    lookahead in a window of voc_bucket(context + chunk + 1) tokens. The
    lookahead makes the conv stack exact against a full decode; the left
    context truncates the sliding-window attention's receptive field (a
    ~1e-5 approximation at the default 25 < window 72). With
    ``context_tokens`` >= the sequence length the output is sample-exact.
    Every chunk is launched before any is fetched; the fetches are the
    span ``vocode_read``."""
    n_tokens = len(codes)
    spt = SAMPLES_PER_TOKEN
    W = voc_bucket(context_tokens + chunk_tokens + 1)
    jobs = []
    for cs in range(0, n_tokens, chunk_tokens):
        ce = min(cs + chunk_tokens, n_tokens)
        ctx = min(context_tokens, cs)
        la_end = min(ce + 1, n_tokens)           # one token of lookahead
        out = decode_fn(pad_window(codes[cs - ctx:la_end], W, device))
        jobs.append(out[0, ctx * spt:(ctx + ce - cs) * spt])
    with profiling.span("vocode_read"):
        parts = [j.cpu().numpy() for j in jobs]
    return np.concatenate(parts) if parts else np.zeros(0, np.float32)


def synthesize_chunked(decode_fn, codes: np.ndarray,
                       max_tokens: int = VOC_CHUNK_SIZE,
                       overlap: int = VOC_OVERLAP,
                       device="cuda") -> np.ndarray:
    """The reference vocoder server's overlap crossfade, kept for the
    compat vocoder server's wire parity (serve/compat.py); every other
    path decodes through synthesize_exact. ``decode_fn`` takes (1,
    max_tokens, 16) int32 on ``device`` and returns (1, max_tokens *
    1920) f32 there. Up to ``max_tokens`` tokens: one zero-padded window,
    trimmed. Past that, windows advance by ``max_tokens - overlap`` and
    each overlap is blended by a linear fade-out/fade-in.

    Wire parity includes the reference's defect: a last window shorter
    than the overlap is appended raw, repeating up to overlap - 1 tokens
    of audio already emitted. Every window is launched before any is
    fetched."""
    n_tokens = len(codes)
    spt = SAMPLES_PER_TOKEN

    def dispatch(chunk: np.ndarray):
        return decode_fn(pad_window(chunk, max_tokens, device)), len(chunk)

    if n_tokens <= max_tokens:
        out, m = dispatch(codes)
        return out[0, :m * spt].cpu().numpy()

    step = max_tokens - overlap
    ov_samples = overlap * spt
    fade_out = np.linspace(1.0, 0.0, ov_samples, dtype=np.float32)
    fade_in = 1.0 - fade_out
    jobs = [dispatch(codes[cs:min(cs + max_tokens, n_tokens)])
            for cs in range(0, n_tokens, step)]
    result = np.array([], dtype=np.float32)
    for i, (out, m) in enumerate(jobs):
        audio_chunk = out[0, :m * spt].cpu().numpy()
        if i == 0:
            result = audio_chunk
        elif len(result) >= ov_samples and len(audio_chunk) >= ov_samples:
            blended = (result[-ov_samples:] * fade_out
                       + audio_chunk[:ov_samples] * fade_in)
            result = np.concatenate(
                [result[:-ov_samples], blended, audio_chunk[ov_samples:]])
        else:
            result = np.concatenate([result, audio_chunk])
    return result


def to_int16_device(audio: torch.Tensor) -> torch.Tensor:
    """to_int16 where the audio lies: clip, scale and cast on the device,
    so a fetch moves int16, not f32."""
    return torch.clamp(audio * 32767.0, -32768.0, 32767.0).to(torch.int16)


def to_int16(audio: np.ndarray) -> np.ndarray:
    """float [-1, 1] -> int16 with the reference clip."""
    if audio.dtype == np.int16:
        return audio
    return np.clip(audio * 32767, -32768, 32767).astype(np.int16)
