"""Speech-tokenizer encoder: waveform -> (T, 16) codec tokens, the
voice-cloning prep. Twin of qwen3_tts_tpu/models/encoder.py.

The decoder's structure (models/vocoder.py) run in reverse:

  wav (B, N) -> causal conv k7 (1 -> decoder_dim / 2^4 channels)
  -> 4 strided blocks [3 residual units (d = 1, 3, 9), SnakeBeta,
     causal conv k = 2r, stride r], channels doubling, rates (3, 4, 5, 8)
  -> causal conv k7 -> hidden_size
  -> 2 ConvNeXt stages, each then a stride-2 causal conv
  -> the sliding-window transformer and its final RMSNorm
  -> latent (B, T, H), N = 1920 * T
  -> 16-stage residual VQ against the decoder's codebooks (its
     ``code_embedding`` as (16, V, H)), so that decoding the codes
     reconstructs the latent by construction.

The block plan and the tensor names are the JAX package's, which
extrapolate the decoder's names under ``encoder.*``; the loader is strict,
so a checkpoint named otherwise fails. FP32 by contract: the forward
runs with TF32 off (vocoder._fp32_exact). Built from the vocoder's
pieces: causal_conv1d, residual_unit, snake_beta, convnext_block and
pre_transformer (which reads only fields EncoderConfig also has)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from qwen3_tts_tpu_torch.config import EncoderConfig, VocoderConfig
from qwen3_tts_tpu_torch.io import weights as weights_io
from qwen3_tts_tpu_torch.models.vocoder import (
    _fp32_exact,
    causal_conv1d,
    convnext_block,
    pre_transformer,
    residual_unit,
    snake_beta,
)

Params = Dict[str, object]


def decoder_codebooks(voc_params: dict, voc_cfg: VocoderConfig
                      ) -> torch.Tensor:
    """The decoder's 16 per-quantizer codebooks, (16, V, H), a view of its
    flat ``code_embedding`` (quantizer q owns rows [q V, (q + 1) V))."""
    nq, v = voc_cfg.num_codebooks, voc_cfg.codebook_size
    return voc_params["code_embedding"].reshape(nq, v, -1)


def _channel_plan(cfg: EncoderConfig):
    """The decoder's plan mirrored: blocks double the channels from
    decoder_dim / 2^n_blocks up to decoder_dim."""
    n = len(cfg.downsample_rates)
    return [cfg.decoder_dim // (2 ** (n - i)) for i in range(n + 1)]


def init_encoder_params(cfg: EncoderConfig, seed: int = 0,
                        device="cpu") -> Params:
    """Random f32 encoder weights from the port's seeded generator, at
    the JAX init's scales (uniform +-1/sqrt(fan_in) weights, zero biases
    and Snake parameters, unit norms). The draws are not jax.random's."""
    init = weights_io._Init(seed, device)
    w, zeros, ones, full = init.uniform, init.zeros, init.ones, init.full
    H, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    ch = _channel_plan(cfg)
    p: Params = {"enc_in_w": w((7, 1, ch[0])), "enc_in_b": zeros((ch[0],)),
                 "blocks": {}}
    for i, r in enumerate(cfg.downsample_rates):
        cin, cout = ch[i], ch[i + 1]
        blk = {"res": {}, "alpha": zeros((cin,)), "beta": zeros((cin,)),
               "down_w": w((2 * r, cin, cout)), "down_b": zeros((cout,))}
        for d_i in range(3):
            blk["res"][str(d_i)] = {
                "alpha1": zeros((cin,)), "beta1": zeros((cin,)),
                "conv1_w": w((7, cin, cin)), "conv1_b": zeros((cin,)),
                "alpha2": zeros((cin,)), "beta2": zeros((cin,)),
                "conv2_w": w((1, cin, cin)), "conv2_b": zeros((cin,)),
            }
        p["blocks"][str(i)] = blk
    p["enc_out_w"] = w((7, ch[-1], H))
    p["enc_out_b"] = zeros((H,))
    p["downsample"] = {}
    for i, f in enumerate(cfg.downsampling_ratios):
        p["downsample"][str(i)] = {
            "cn_dw_w": w((7, 1, H)), "cn_dw_b": zeros((H,)),
            "cn_ln_w": ones((H,)), "cn_ln_b": zeros((H,)),
            "cn_pw1_w": w((H, 4 * H)), "cn_pw1_b": zeros((4 * H,)),
            "cn_pw2_w": w((4 * H, H)), "cn_pw2_b": zeros((H,)),
            "cn_gamma": full((H,), 1e-6),
            "down_w": w((f, H, H)), "down_b": zeros((H,)),
        }
    layers = {
        "input_ln": ones((L, H)), "post_ln": ones((L, H)),
        "q_proj": w((L, H, H)), "k_proj": w((L, H, H)),
        "v_proj": w((L, H, H)), "o_proj": w((L, H, H)),
        "gate_proj": w((L, H, I)), "up_proj": w((L, H, I)),
        "down_proj": w((L, I, H)),
        "attn_scale": full((L, H), cfg.layer_scale_initial_scale),
        "mlp_scale": full((L, H), cfg.layer_scale_initial_scale),
    }
    p["post"] = {"layers": layers, "norm": ones((H,))}
    return p


def encode_features(params: Params, wav: torch.Tensor,
                    cfg: EncoderConfig) -> torch.Tensor:
    """wav (B, N) f32 in [-1, 1], N a multiple of total_downsample (1920)
    -> (B, N / 1920, H) latent frames."""
    with _fp32_exact():
        x = wav[:, :, None].float()
        x = causal_conv1d(x, params["enc_in_w"], params["enc_in_b"])
        for i, r in enumerate(cfg.downsample_rates):
            blk = params["blocks"][str(i)]
            for d_i, dil in enumerate((1, 3, 9)):
                x = residual_unit(blk["res"][str(d_i)], x, dil)
            x = snake_beta(x, blk["alpha"], blk["beta"])
            x = causal_conv1d(x, blk["down_w"], blk["down_b"], stride=r)
        x = causal_conv1d(x, params["enc_out_w"], params["enc_out_b"])
        for i, f in enumerate(cfg.downsampling_ratios):
            st = params["downsample"][str(i)]
            x = convnext_block(st, x)
            x = causal_conv1d(x, st["down_w"], st["down_b"], stride=f)
        return pre_transformer(params["post"], x, cfg)


def rvq_distances(resid: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """|c|^2 - 2 r.c for every row c of one codebook (V, H) and every
    residual row (B, T, H): ||r - c||^2 less the constant |r|^2, in f32."""
    with _fp32_exact():
        cb = cb.float()
        dots = torch.einsum("btd,vd->btv", resid.float(), cb)
        norms = torch.sum(cb * cb, dim=-1)
        return norms[None, None, :] - 2.0 * dots


def rvq_encode(codebooks: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Greedy residual VQ against the decoder's codebooks (16, V, H)
    (``decoder_codebooks``). The decoder reconstructs a latent as the
    mean of its 16 codebook rows (vocoder.decode_raw), so the target is
    16 * z. Each stage takes the row of least ``rvq_distances``
    (torch.argmin: the first index of a tie) and subtracts it. Returns
    codes (B, T, 16) int32."""
    resid = z.float() * codebooks.shape[0]
    codes = []
    for q in range(codebooks.shape[0]):
        cb = codebooks[q].float()
        idx = torch.argmin(rvq_distances(resid, cb), dim=-1)
        resid = resid - cb[idx]
        codes.append(idx.to(torch.int32))
    return torch.stack(codes, dim=-1)


def encode(enc_params: Params, codebooks: torch.Tensor, wav: torch.Tensor,
           cfg: EncoderConfig) -> torch.Tensor:
    """Waveform (B, N) -> latent -> RVQ codes (B, N / 1920, 16)."""
    return rvq_encode(codebooks, encode_features(enc_params, wav, cfg))


def load_encoder_from_state_dict(sd, cfg: EncoderConfig) -> Params:
    """The speech tokenizer's ``encoder.`` tensors (that prefix stripped)
    in the encoder's f32 tree, on the host. Names mirror the decoder's
    torch naming; strict: KeyError for a missing tensor, ValueError for
    one the loader did not consume."""
    get, check_consumed = weights_io.strict_getter(sd, "encoder")
    conv_w = weights_io._conv_w
    p: Params = {"enc_in_w": conv_w(get("encoder.0.conv.weight")),
                 "enc_in_b": get("encoder.0.conv.bias"), "blocks": {}}
    n_blocks = len(cfg.downsample_rates)
    for i in range(n_blocks):
        d = f"encoder.{i + 1}.block."
        p["blocks"][str(i)] = {
            "res": {str(d_i): weights_io.residual_unit_params(get,
                                                              d + f"{d_i}.")
                    for d_i in range(3)},
            "alpha": get(d + "3.alpha"),
            "beta": get(d + "3.beta"),
            "down_w": conv_w(get(d + "4.conv.weight")),
            "down_b": get(d + "4.conv.bias"),
        }
    p["enc_out_w"] = conv_w(get(f"encoder.{n_blocks + 1}.conv.weight"))
    p["enc_out_b"] = get(f"encoder.{n_blocks + 1}.conv.bias")
    p["downsample"] = {}
    for i in range(len(cfg.downsampling_ratios)):
        u = f"downsample.{i}."
        p["downsample"][str(i)] = {
            **weights_io.convnext_params(get, u + "0."),
            "down_w": conv_w(get(u + "1.conv.weight")),
            "down_b": get(u + "1.conv.bias"),
        }
    p["post"] = weights_io.window_transformer_params(get, "post_transformer",
                                               cfg.num_hidden_layers)
    check_consumed()
    return p


# ---------------------------------------------------------------------------
# Host-side audio prep
# ---------------------------------------------------------------------------

def pad_to_tokens(wav: np.ndarray, samples_per_token: int = 1920) -> np.ndarray:
    """Zero-pad a host waveform to a whole number of tokens."""
    pad = (-len(wav)) % samples_per_token
    if pad:
        wav = np.concatenate([wav, np.zeros(pad, np.float32)])
    return wav


def resample_linear(wav: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Linear interpolation from ``sr_in`` to ``sr_out`` (reference-audio
    prep), f32."""
    if sr_in == sr_out:
        return wav.astype(np.float32)
    n_out = int(round(len(wav) * sr_out / sr_in))
    x_out = np.linspace(0.0, len(wav) - 1, n_out)
    return np.interp(x_out, np.arange(len(wav)), wav).astype(np.float32)
