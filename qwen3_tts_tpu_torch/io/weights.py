"""Weights for the port: random initialisation at the JAX package's
scales, and conversion of the JAX package's parameters (as numpy) into
the port's tensors. Twin of the random-init half of
qwen3_tts_tpu/io/weights.py; checkpoint loading is not ported yet.

Both produce {"talker", "code_predictor", "vocoder"} dicts with the JAX
names and layouts; int8 weights are ops/quant.QTensor."""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from qwen3_tts_tpu_torch.config import TTSConfig
from qwen3_tts_tpu_torch.models import transformer as tfm
from qwen3_tts_tpu_torch.ops.quant import QTensor, attach_layer_list


class _Init:
    """Seeded draws on one device."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

    def normal(self, shape, dtype, scale=0.02):
        return (torch.randn(shape, generator=self.gen, device=self.device)
                * scale).to(dtype)

    def uniform(self, shape, fan_in=None):
        fan = fan_in if fan_in is not None else int(np.prod(shape[:-1]))
        s = 1.0 / math.sqrt(max(fan, 1))
        u = torch.rand(shape, generator=self.gen, device=self.device)
        return u * (2 * s) - s

    def ones(self, shape, dtype=torch.float32):
        return torch.ones(shape, dtype=dtype, device=self.device)

    def zeros(self, shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def full(self, shape, value):
        return torch.full(shape, value, dtype=torch.float32,
                          device=self.device)


def _stack(init: _Init, geo: tfm.TransformerGeometry, dtype) -> dict:
    L, H, I = geo.num_layers, geo.hidden_size, geo.intermediate_size
    QD, KVD = geo.num_heads * geo.head_dim, geo.num_kv_heads * geo.head_dim
    Dh = geo.head_dim
    return {
        "input_ln": init.ones((L, H), dtype),
        "q_proj": init.normal((L, H, QD), dtype),
        "k_proj": init.normal((L, H, KVD), dtype),
        "v_proj": init.normal((L, H, KVD), dtype),
        "o_proj": init.normal((L, QD, H), dtype),
        "q_norm": init.ones((L, Dh), dtype),
        "k_norm": init.ones((L, Dh), dtype),
        "post_ln": init.ones((L, H), dtype),
        "gate_proj": init.normal((L, H, I), dtype),
        "up_proj": init.normal((L, H, I), dtype),
        "down_proj": init.normal((L, I, H), dtype),
    }


def _talker(init: _Init, cfg, dtype) -> dict:
    E, H, Vc = cfg.text_embed_dim, cfg.hidden_size, cfg.codec_vocab_size
    return {
        "layers": _stack(init, tfm.geometry_of(cfg), dtype),
        "final_norm": init.ones((H,), dtype),
        "text_embedding": init.normal((cfg.text_vocab_size, E), dtype),
        "proj_fc1_w": init.normal((E, E), dtype),
        "proj_fc1_b": init.zeros((E,), dtype),
        "proj_fc2_w": init.normal((E, H), dtype),
        "proj_fc2_b": init.zeros((H,), dtype),
        "codec_embedding": init.normal((Vc, H), dtype),
        "codec_head": init.normal((H, Vc), dtype),
    }


def _code_predictor(init: _Init, cfg, dtype) -> dict:
    H, G, V = cfg.hidden_size, cfg.num_groups, cfg.group_vocab_size
    return {
        "layers": _stack(init, tfm.geometry_of(cfg), dtype),
        "final_norm": init.ones((H,), dtype),
        "mtp_proj_w": init.normal((H, H), dtype),
        "mtp_proj_b": init.zeros((H,), dtype),
        "codec_embs": init.normal((G, V, H), dtype),
        "lm_heads": init.normal((G, H, V), dtype),
    }


def _vocoder(init: _Init, cfg) -> dict:
    """The torch decoder's tensor shapes in the JAX layouts, all f32."""
    w = init.uniform
    H, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    layers = {
        "input_ln": init.ones((L, H)), "post_ln": init.ones((L, H)),
        "q_proj": w((L, H, H)), "k_proj": w((L, H, H)),
        "v_proj": w((L, H, H)), "o_proj": w((L, H, H)),
        "gate_proj": w((L, H, I)), "up_proj": w((L, H, I)),
        "down_proj": w((L, I, H)),
        "attn_scale": init.full((L, H), cfg.layer_scale_initial_scale),
        "mlp_scale": init.full((L, H), cfg.layer_scale_initial_scale),
    }
    p = {
        "code_embedding": w((cfg.num_codebooks * cfg.codebook_size, H),
                            fan_in=H),
        "pre": {"layers": layers, "norm": init.ones((H,))},
        "upsample": {},
        "blocks": {},
    }
    for i, f in enumerate(cfg.upsampling_ratios):
        p["upsample"][str(i)] = {
            "up_w": w((f, H, H)), "up_b": init.zeros((H,)),
            "cn_dw_w": w((7, 1, H)), "cn_dw_b": init.zeros((H,)),
            "cn_ln_w": init.ones((H,)), "cn_ln_b": init.zeros((H,)),
            "cn_pw1_w": w((H, 4 * H)), "cn_pw1_b": init.zeros((4 * H,)),
            "cn_pw2_w": w((4 * H, H)), "cn_pw2_b": init.zeros((H,)),
            "cn_gamma": init.full((H,), 1e-6),
        }
    D = cfg.decoder_dim
    p["dec_in_w"] = w((7, H, D))
    p["dec_in_b"] = init.zeros((D,))
    cin = D
    for i, r in enumerate(cfg.upsample_rates):
        cout = D // (2 ** (i + 1))
        blk = {"alpha": init.zeros((cin,)), "beta": init.zeros((cin,)),
               "up_w": w((2 * r, cin, cout)), "up_b": init.zeros((cout,)),
               "res": {}}
        for d_i in range(3):
            blk["res"][str(d_i)] = {
                "alpha1": init.zeros((cout,)), "beta1": init.zeros((cout,)),
                "conv1_w": w((7, cout, cout)), "conv1_b": init.zeros((cout,)),
                "alpha2": init.zeros((cout,)), "beta2": init.zeros((cout,)),
                "conv2_w": w((1, cout, cout)), "conv2_b": init.zeros((cout,)),
            }
        p["blocks"][str(i)] = blk
        cin = cout
    p["out_alpha"] = init.zeros((cin,))
    p["out_beta"] = init.zeros((cin,))
    p["out_w"] = w((7, cin, 1))
    p["out_b"] = init.zeros((1,))
    return p


def init_random_params(cfg: TTSConfig, seed: int = 0, dtype=torch.bfloat16,
                       device="cpu") -> Dict[str, dict]:
    """Random parameters drawn on ``device`` from a seeded
    torch.Generator, at the JAX inits' scales (N(0, 0.02) projections and
    embeddings, unit norms; uniform +-1/sqrt(fan_in) vocoder weights). The
    vocoder is f32 whatever ``dtype`` is."""
    init = _Init(seed, device)
    return {
        "talker": _talker(init, cfg.talker, dtype),
        "code_predictor": _code_predictor(init, cfg.code_predictor, dtype),
        "vocoder": _vocoder(init, cfg.vocoder),
    }


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def from_jax_numpy(tree: dict, device="cpu") -> Dict[str, dict]:
    """The JAX package's params, converted to numpy by the caller (each
    QTensor as a (q, scale) tuple), as the port's params: arrays become
    tensors, (q, scale) becomes a QTensor, and ``layers_list`` is rebuilt
    for quantized components."""

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()
                    if k != "layers_list"}
        if isinstance(node, tuple):
            q, scale = node
            return QTensor(_tensor(q, device), _tensor(scale, device))
        return _tensor(node, device)

    out = {}
    for name, comp in tree.items():
        comp = conv(comp)
        if any(isinstance(v, QTensor)
               for v in comp.get("layers", {}).values()):
            comp = attach_layer_list(comp)
        out[name] = comp
    return out
