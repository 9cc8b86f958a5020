"""Weights for the port. Twin of qwen3_tts_tpu/io/weights.py:

- random initialisation at the JAX package's scales
  (``init_random_params``), and the JAX package's parameters as numpy
  into the port's tensors (``from_jax_numpy``);
- the native checkpoint format, ``params.npz`` (``save_pytree_npz``,
  ``load_pytree_npz``, ``read_npz_config``), with JAX's key grammar, so
  either package reads the other's files;
- the HF Qwen3-TTS checkpoint (``model.safetensors`` and
  ``speech_tokenizer/model.safetensors``) mapped into the JAX names and
  (in, out) layouts (``load_talker_from_hf``, ``load_code_predictor_from_hf``,
  ``load_vocoder_from_state_dict``, ``load_speech_tokenizer``), the
  geometry read from the header (``detect_tts_config``), and
  ``load_params``, which resolves a model directory to weights.

Trees are {"talker", "code_predictor", "vocoder"[, "encoder"]} dicts with
the JAX names and layouts; int8 weights are ops/quant.QTensor. A
checkpoint is mapped on the host and moved to its device once."""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import sys
import warnings
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from qwen3_tts_tpu_torch.config import (
    CodePredictorConfig,
    EncoderConfig,
    SamplingConfig,
    TalkerConfig,
    TTSConfig,
    VocoderConfig,
)
from qwen3_tts_tpu_torch.io.safetensors import (
    list_safetensors_keys,
    read_safetensors,
)
from qwen3_tts_tpu_torch.models import transformer as tfm
from qwen3_tts_tpu_torch.ops.quant import (
    QTensor,
    attach_layer_list,
    is_quantized,
)
from qwen3_tts_tpu_torch.utils.profiling import stage

Params = Dict[str, dict]


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


def init_vocoder_params(cfg: VocoderConfig, seed: int = 0,
                        device="cpu") -> dict:
    """A random f32 vocoder drawn from ``seed`` (``load_params`` for a
    checkpoint without one)."""
    return _vocoder(_Init(seed, device), cfg)


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def _map_tree(tree: dict, leaf, qleaf) -> Params:
    """Each component of ``tree`` with its tensors through ``leaf`` and
    its int8 weights through ``qleaf``; ``layers_list`` is dropped and
    rebuilt (quant.attach_layer_list) for quantized components."""

    def conv(node):
        if isinstance(node, Mapping):
            return {k: conv(v) for k, v in node.items()
                    if k != "layers_list"}
        if isinstance(node, (tuple, QTensor)):
            return qleaf(node)
        return leaf(node)

    out = {}
    for name, comp in tree.items():
        comp = conv(comp)
        if isinstance(comp, dict) and is_quantized(comp):
            comp = attach_layer_list(comp)
        out[name] = comp
    return out


def from_jax_numpy(tree: dict, device="cpu") -> Params:
    """The JAX package's params, converted to numpy by the caller (each
    QTensor as a (q, scale) tuple), as the port's params: arrays become
    tensors, (q, scale) becomes a QTensor, and ``layers_list`` is rebuilt
    for quantized components."""
    return _map_tree(
        tree, lambda a: _tensor(a, device),
        lambda qs: QTensor(_tensor(qs[0], device), _tensor(qs[1], device)))


def to_device(tree: dict, device) -> Params:
    """A param tree (tensors and QTensors) moved to ``device``."""
    return _map_tree(tree, lambda t: t.to(device),
                     lambda w: QTensor(w.q.to(device), w.scale.to(device)))


# ---------------------------------------------------------------------------
# The native checkpoint format: params.npz
# ---------------------------------------------------------------------------

_CONFIG_KEY = "__config__"  # JSON TTSConfig embedded in params.npz


def _np_leaf(t: torch.Tensor):
    """(key suffix, numpy array) of a tensor: bf16 as its uint16 bits
    under "::bf16" (npz has no bf16)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return "::bf16", t.view(torch.int16).numpy().view(np.uint16)
    return "", t.numpy()


def save_pytree_npz(path: str, tree: dict,
                    config: Optional[TTSConfig] = None) -> None:
    """A param tree as an npz of the JAX package's key grammar: nested
    names joined by "/", bf16 as uint16 bits under "name::bf16", a
    QTensor as "name::q8" (int8) and "name::q8s" (f32 scales);
    ``layers_list`` is never stored. ``config`` is embedded as JSON bytes
    under "__config__", so a loader never guesses the geometry that
    shapes do not give (the vocoder's heads and window, eps, theta)."""
    flat = {}

    def rec(prefix, node):
        if isinstance(node, Mapping):
            for k, v in node.items():
                if k != "layers_list":
                    rec(f"{prefix}/{k}" if prefix else k, v)
        elif isinstance(node, QTensor):
            flat[prefix + "::q8"] = node.q.detach().cpu().numpy()
            flat[prefix + "::q8s"] = node.scale.detach().cpu().numpy()
        else:
            suffix, arr = _np_leaf(node)
            flat[prefix + suffix] = arr

    rec("", tree)
    if config is not None:
        js = json.dumps(dataclasses.asdict(config)).encode()
        flat[_CONFIG_KEY] = np.frombuffer(js, np.uint8)
    np.savez(path, **flat)


def read_npz_config(path: str) -> Optional[TTSConfig]:
    """The TTSConfig embedded by save_pytree_npz(config=...) (either
    package's), or None for a file without one (callers fall back to
    config_from_params)."""
    with np.load(path) as data:
        if _CONFIG_KEY not in data.files:
            return None
        d = json.loads(data[_CONFIG_KEY].tobytes().decode())

    def mk(cls, dd):
        # JSON turns tuples into lists; frozen configs need tuples back
        return cls(**{k: (tuple(v) if isinstance(v, list) else v)
                      for k, v in dd.items()})

    return TTSConfig(
        talker=mk(TalkerConfig, d["talker"]),
        code_predictor=mk(CodePredictorConfig, d["code_predictor"]),
        vocoder=mk(VocoderConfig, d["vocoder"]),
        encoder=mk(EncoderConfig, d["encoder"]),
        sampling=mk(SamplingConfig, d["sampling"]),
        max_tokens=d["max_tokens"],
    )


def load_pytree_npz(path: str, dtype=None) -> Params:
    """The tree save_pytree_npz (either package's) wrote, on the host:
    floats cast to ``dtype`` when it is given, QTensors reassembled (their
    scales f32 whatever ``dtype`` is) and ``layers_list`` rebuilt."""
    tree: dict = {}
    q8: Dict[str, np.ndarray] = {}
    q8s: Dict[str, np.ndarray] = {}

    def put(name, leaf):
        parts = name.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf

    with np.load(path) as data:
        for key in data.files:
            if key == _CONFIG_KEY:
                continue
            arr = data[key]
            if key.endswith("::q8"):
                q8[key[:-len("::q8")]] = arr
                continue
            if key.endswith("::q8s"):
                q8s[key[:-len("::q8s")]] = arr
                continue
            if key.endswith("::bf16"):
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
                key = key[:-len("::bf16")]
            else:
                t = torch.from_numpy(arr)
            if dtype is not None and t.is_floating_point():
                t = t.to(dtype)
            put(key, t)
    for name, q in q8.items():
        if name not in q8s:
            raise ValueError(f"{path}: quantized tensor {name!r} has no "
                             "::q8s scale entry (truncated checkpoint?)")
        put(name, QTensor(torch.from_numpy(q),
                          torch.from_numpy(q8s[name]).float()))
    return _map_tree(tree, lambda t: t, lambda w: w)


# ---------------------------------------------------------------------------
# HF safetensors: the talker and the code predictor
# ---------------------------------------------------------------------------

def _as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))


def _stack_layers(get: Callable[[str], torch.Tensor], prefix: str,
                  num_layers: int, dtype) -> dict:
    """The stacked layer dict from per-layer HF tensors; projections
    transposed from HF's (out, in) to (in, out)."""
    def t(name):
        return torch.stack([get(f"{prefix}.{i}.{name}").T
                            for i in range(num_layers)]).to(dtype)

    def raw(name):
        return torch.stack([get(f"{prefix}.{i}.{name}")
                            for i in range(num_layers)]).to(dtype)

    return {
        "input_ln": raw("input_layernorm.weight"),
        "q_proj": t("self_attn.q_proj.weight"),
        "k_proj": t("self_attn.k_proj.weight"),
        "v_proj": t("self_attn.v_proj.weight"),
        "o_proj": t("self_attn.o_proj.weight"),
        "q_norm": raw("self_attn.q_norm.weight"),
        "k_norm": raw("self_attn.k_norm.weight"),
        "post_ln": raw("post_attention_layernorm.weight"),
        "gate_proj": t("mlp.gate_proj.weight"),
        "up_proj": t("mlp.up_proj.weight"),
        "down_proj": t("mlp.down_proj.weight"),
    }


def load_talker_from_hf(weights: Mapping, cfg: TalkerConfig,
                        dtype=torch.bfloat16) -> dict:
    """The HF checkpoint's talker tensors in the talker's tree."""
    get = lambda k: _as_tensor(weights[k])  # noqa: E731
    return {
        "layers": _stack_layers(get, "talker.model.layers", cfg.num_layers,
                                dtype),
        "final_norm": get("talker.model.norm.weight").to(dtype),
        "text_embedding": get("talker.model.text_embedding.weight").to(dtype),
        "proj_fc1_w": get("talker.text_projection.linear_fc1.weight").T
        .contiguous().to(dtype),
        "proj_fc1_b": get("talker.text_projection.linear_fc1.bias").to(dtype),
        "proj_fc2_w": get("talker.text_projection.linear_fc2.weight").T
        .contiguous().to(dtype),
        "proj_fc2_b": get("talker.text_projection.linear_fc2.bias").to(dtype),
        "codec_embedding": get("talker.model.codec_embedding.weight")
        .to(dtype),
        "codec_head": get("talker.codec_head.weight").T.contiguous()
        .to(dtype),
    }


def load_code_predictor_from_hf(weights: Mapping, cfg: CodePredictorConfig,
                                dtype=torch.bfloat16) -> dict:
    """The code predictor's tensors; without small_to_mtp_projection
    (checkpoints whose predictor is as wide as the talker) the identity
    and a zero bias."""
    get = lambda k: _as_tensor(weights[k])  # noqa: E731
    pre = "talker.code_predictor"
    mtp_w_key = f"{pre}.small_to_mtp_projection.weight"
    mtp_b_key = f"{pre}.small_to_mtp_projection.bias"
    H = cfg.hidden_size
    mtp_w = (get(mtp_w_key).T.contiguous().to(dtype) if mtp_w_key in weights
             else torch.eye(H, dtype=dtype))
    mtp_b = (get(mtp_b_key).to(dtype) if mtp_b_key in weights
             else torch.zeros((H,), dtype=dtype))
    return {
        "layers": _stack_layers(get, f"{pre}.model.layers", cfg.num_layers,
                                dtype),
        "final_norm": get(f"{pre}.model.norm.weight").to(dtype),
        "mtp_proj_w": mtp_w,
        "mtp_proj_b": mtp_b,
        "codec_embs": torch.stack(
            [get(f"{pre}.model.codec_embedding.{g}.weight")
             for g in range(cfg.num_groups)]).to(dtype),
        "lm_heads": torch.stack(
            [get(f"{pre}.lm_head.{g}.weight").T
             for g in range(cfg.num_groups)]).to(dtype),
    }


# ---------------------------------------------------------------------------
# HF safetensors: the speech tokenizer (vocoder and encoder)
# ---------------------------------------------------------------------------

def _conv_w(a: torch.Tensor) -> torch.Tensor:
    """torch Conv1d weight (Cout, Cin/groups, K) -> WIO (K, Cin/g, Cout)."""
    return a.float().permute(2, 1, 0).contiguous()


def _tconv_w(a: torch.Tensor) -> torch.Tensor:
    """torch ConvTranspose1d weight (Cin, Cout, K) -> the pre-flipped WIO
    (K, Cin, Cout) that vocoder.causal_trans_conv1d takes."""
    return a.float().permute(2, 0, 1).flip(0).contiguous()


def strict_getter(sd: Mapping, what: str):
    """(get, check_consumed) for a strict loader: ``get(k)`` is sd[k] as
    f32 (KeyError naming the tensor when absent); ``check_consumed()``
    raises ValueError listing tensors no ``get`` asked for."""
    used = set()

    def get(k: str) -> torch.Tensor:
        if k not in sd:
            raise KeyError(f"{what} checkpoint missing tensor: {k!r}")
        used.add(k)
        return _as_tensor(sd[k]).float()

    def check_consumed() -> None:
        unused = set(sd) - used
        if unused:
            raise ValueError(
                f"{what} checkpoint has tensors the loader did not consume "
                f"(architecture mismatch?): {sorted(unused)[:10]}"
                f"{' ...' if len(unused) > 10 else ''}")

    return get, check_consumed


def window_transformer_params(get, prefix: str, num_layers: int) -> dict:
    """The sliding-window transformer's stacked layers (vocoder.
    pre_transformer's tree) from per-layer tensors under ``prefix``."""
    pre = prefix + ".layers.{i}."

    def stack(fmt: str, transpose: bool) -> torch.Tensor:
        arrs = [get(fmt.format(i=i)) for i in range(num_layers)]
        return torch.stack([a.T for a in arrs] if transpose else arrs)

    return {
        "layers": {
            "input_ln": stack(pre + "input_layernorm.weight", False),
            "post_ln": stack(pre + "post_attention_layernorm.weight", False),
            "q_proj": stack(pre + "self_attn.q_proj.weight", True),
            "k_proj": stack(pre + "self_attn.k_proj.weight", True),
            "v_proj": stack(pre + "self_attn.v_proj.weight", True),
            "o_proj": stack(pre + "self_attn.o_proj.weight", True),
            "gate_proj": stack(pre + "mlp.gate_proj.weight", True),
            "up_proj": stack(pre + "mlp.up_proj.weight", True),
            "down_proj": stack(pre + "mlp.down_proj.weight", True),
            "attn_scale": stack(pre + "self_attn_layer_scale.scale", False),
            "mlp_scale": stack(pre + "mlp_layer_scale.scale", False),
        },
        "norm": get(prefix + ".norm.weight"),
    }


def convnext_params(get, u: str) -> dict:
    """A ConvNeXt block's tensors under the module prefix ``u``."""
    return {
        "cn_dw_w": _conv_w(get(u + "dwconv.conv.weight")),
        "cn_dw_b": get(u + "dwconv.conv.bias"),
        "cn_ln_w": get(u + "norm.weight"),
        "cn_ln_b": get(u + "norm.bias"),
        "cn_pw1_w": get(u + "pwconv1.weight").T.contiguous(),
        "cn_pw1_b": get(u + "pwconv1.bias"),
        "cn_pw2_w": get(u + "pwconv2.weight").T.contiguous(),
        "cn_pw2_b": get(u + "pwconv2.bias"),
        "cn_gamma": get(u + "gamma"),
    }


def residual_unit_params(get, r: str) -> dict:
    """A residual unit's tensors (SnakeBeta, conv, SnakeBeta, conv) under
    the module prefix ``r``."""
    return {
        "alpha1": get(r + "act1.alpha"), "beta1": get(r + "act1.beta"),
        "conv1_w": _conv_w(get(r + "conv1.conv.weight")),
        "conv1_b": get(r + "conv1.conv.bias"),
        "alpha2": get(r + "act2.alpha"), "beta2": get(r + "act2.beta"),
        "conv2_w": _conv_w(get(r + "conv2.conv.weight")),
        "conv2_b": get(r + "conv2.conv.bias"),
    }


def load_vocoder_from_state_dict(sd: Mapping, cfg: VocoderConfig) -> dict:
    """The speech tokenizer decoder's tensors (the torch state_dict names
    of Qwen3TTSTokenizerV2Model.decoder, the ``decoder.`` prefix
    stripped) in the vocoder's f32 tree. Strict: KeyError for a missing
    tensor, ValueError for one the loader did not consume."""
    get, check_consumed = strict_getter(sd, "vocoder")
    p = {
        "code_embedding": get("code_embedding.weight"),
        "pre": window_transformer_params(get, "pre_transformer",
                                   cfg.num_hidden_layers),
        "upsample": {},
    }
    for i in range(len(cfg.upsampling_ratios)):
        u = f"upsample.{i}."
        p["upsample"][str(i)] = {
            "up_w": _tconv_w(get(u + "0.conv.weight")),
            "up_b": get(u + "0.conv.bias"),
            **convnext_params(get, u + "1."),
        }
    p["dec_in_w"] = _conv_w(get("decoder.0.conv.weight"))
    p["dec_in_b"] = get("decoder.0.conv.bias")
    p["blocks"] = {}
    n_blocks = len(cfg.upsample_rates)
    for i in range(n_blocks):
        d = f"decoder.{i + 1}.block."
        p["blocks"][str(i)] = {
            "alpha": get(d + "0.alpha"),
            "beta": get(d + "0.beta"),
            "up_w": _tconv_w(get(d + "1.conv.weight")),
            "up_b": get(d + "1.conv.bias"),
            "res": {str(d_i): residual_unit_params(get, d + f"{d_i + 2}.")
                    for d_i in range(3)},
        }
    post = f"decoder.{n_blocks + 1}."
    p["out_alpha"] = get(post + "alpha")
    p["out_beta"] = get(post + "beta")
    p["out_w"] = _conv_w(get(f"decoder.{n_blocks + 2}.conv.weight"))
    p["out_b"] = get(f"decoder.{n_blocks + 2}.conv.bias")
    check_consumed()
    return p


def split_speech_tokenizer_state_dict(weights: Mapping) -> Dict[str, dict]:
    """A speech tokenizer checkpoint's tensors split by top-level prefix
    (``decoder.`` / ``encoder.``, stripped); tensors with neither prefix
    go under ''."""
    out: Dict[str, dict] = {}
    for k, v in weights.items():
        for prefix in ("decoder.", "encoder."):
            if k.startswith(prefix):
                out.setdefault(prefix[:-1], {})[k[len(prefix):]] = v
                break
        else:
            out.setdefault("", {})[k] = v
    return out


def load_speech_tokenizer(st_dir: str, cfg: TTSConfig,
                          timings: Optional[Dict[str, float]] = None,
                          ) -> Dict[str, dict]:
    """The vocoder (and the encoder, when the checkpoint has ``encoder.``
    tensors) from a ``speech_tokenizer/`` directory's model.safetensors,
    on the host (``timings``: load_params'). Tensor groups neither loader
    consumes are named on stderr."""
    from qwen3_tts_tpu_torch.models import encoder as enc
    timings = {} if timings is None else timings
    st_path = os.path.join(st_dir, "model.safetensors")
    with stage(timings, "read"):
        weights = read_safetensors(st_path)
    groups = split_speech_tokenizer_state_dict(weights)
    dec_sd = groups.get("decoder") or groups.get("")
    if not dec_sd:
        raise KeyError(f"no decoder tensors found in {st_path}")
    ignored = sorted(g for g in groups if g not in ("decoder", "encoder", ""))
    if ignored or ("decoder" in groups and groups.get("")):
        extra = ignored + (["<unprefixed>"]
                           if "decoder" in groups and groups.get("") else [])
        print(f"warning: speech_tokenizer checkpoint has tensor groups "
              f"the loaders do not consume: {extra}", file=sys.stderr)
    with stage(timings, "map"):
        out = {"vocoder": load_vocoder_from_state_dict(dec_sd, cfg.vocoder)}
        if "encoder" in groups:
            out["encoder"] = enc.load_encoder_from_state_dict(
                groups["encoder"], cfg.encoder)
    return out


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _json_scalars(model_dir: str, num_layers: int, hidden: int,
                  want_cp: bool) -> dict:
    """rms_norm_eps and rope_theta (not in any shape) from the
    checkpoint's config.json: the sub-configs whose num_hidden_layers
    (and hidden_size, where given) match the stack, those whose key path
    names the code predictor ("code_predictor" or "mtp") first when
    ``want_cp``, last otherwise; each scalar from the first that has it."""
    path = os.path.join(model_dir, "config.json")
    if not os.path.exists(path):
        return {}
    try:
        with open(path) as f:
            tree = json.load(f)
    except (OSError, ValueError):
        return {}
    cands: list = []  # (key path, node)

    def walk(node, npath):
        if isinstance(node, dict):
            if (node.get("num_hidden_layers") == num_layers
                    and node.get("hidden_size", hidden) == hidden):
                cands.append((npath, node))
            for k, v in node.items():
                walk(v, f"{npath}.{k}")
        elif isinstance(node, list):
            for v in node:
                walk(v, npath)

    walk(tree, "")
    cands.sort(key=lambda c: (("code_predictor" in c[0] or "mtp" in c[0])
                              == want_cp), reverse=True)
    found: dict = {}
    for _, node in cands:
        for key in ("rms_norm_eps", "rope_theta"):
            if key not in found and isinstance(node.get(key), (int, float)):
                found[key] = float(node[key])
    return found


def detect_tts_config(model_dir: str, base: Optional[TTSConfig] = None,
                      ) -> TTSConfig:
    """The talker's and the code predictor's geometry from
    ``model.safetensors``'s header alone (no weight bytes), eps and theta
    from config.json (``_json_scalars``) or else ``base``'s; the serving
    choices (max_seq_len, max_tokens) and the vocoder and encoder stay
    ``base``'s. FileNotFoundError without model.safetensors, KeyError when
    the header lacks the expected names."""
    base = base or TTSConfig()
    shapes = {k: s for k, (_, s) in list_safetensors_keys(
        os.path.join(model_dir, "model.safetensors")).items()}

    def n_layers(prefix: str) -> int:
        pat = re.compile(re.escape(prefix) + r"\.(\d+)\.input_layernorm")
        idx = [int(m.group(1)) for k in shapes if (m := pat.match(k))]
        if not idx:
            raise KeyError(f"no layers found under {prefix!r}")
        return max(idx) + 1

    def stack_geo(prefix: str) -> dict:
        l0 = f"{prefix}.0.self_attn."
        head_dim = shapes[l0 + "q_norm.weight"][0]
        q_out, hidden = shapes[l0 + "q_proj.weight"]
        kv_out = shapes[l0 + "k_proj.weight"][0]
        inter = shapes[f"{prefix}.0.mlp.gate_proj.weight"][0]
        return dict(num_layers=n_layers(prefix), hidden_size=hidden,
                    intermediate_size=inter, head_dim=head_dim,
                    num_heads=q_out // head_dim,
                    num_kv_heads=kv_out // head_dim)

    tg = stack_geo("talker.model.layers")
    text_vocab, text_dim = shapes["talker.model.text_embedding.weight"]
    codec_vocab = shapes["talker.model.codec_embedding.weight"][0]
    talker = dataclasses.replace(
        base.talker, **tg, text_vocab_size=text_vocab,
        text_embed_dim=text_dim, codec_vocab_size=codec_vocab,
        **_json_scalars(model_dir, tg["num_layers"], tg["hidden_size"],
                        want_cp=False))

    cg = stack_geo("talker.code_predictor.model.layers")
    pat = re.compile(r"talker\.code_predictor\.lm_head\.(\d+)\.weight")
    groups = [int(m.group(1)) for k in shapes if (m := pat.match(k))]
    if not groups:
        raise KeyError("no talker.code_predictor.lm_head.N.weight tensors")
    num_groups = max(groups) + 1
    cp = dataclasses.replace(
        base.code_predictor, **cg, num_groups=num_groups,
        group_vocab_size=shapes["talker.code_predictor.lm_head.0.weight"][0],
        # 2-token prefill + (num_groups - 1) decode steps
        max_seq_len=num_groups + 1,
        **_json_scalars(model_dir, cg["num_layers"], cg["hidden_size"],
                        want_cp=True))
    return dataclasses.replace(base, talker=talker, code_predictor=cp)


def config_from_params(params: Mapping,
                       base: Optional[TTSConfig] = None) -> TTSConfig:
    """The talker's and the code predictor's geometry from loaded params
    (a params.npz without ``__config__``; an int8 code predictor too, not
    a fused int8 talker, as JAX's); eps, theta, the vocoder and the
    encoder stay ``base``'s, since no shape gives them."""
    base = base or TTSConfig()

    def shape(w):
        return tuple((w.q if isinstance(w, QTensor) else w).shape)

    def stack_geo(comp):
        lay = comp["layers"]
        head_dim = shape(lay["q_norm"])[-1]
        L, H, q_dim = shape(lay["q_proj"])
        kv_dim = shape(lay["k_proj"])[-1]
        inter = shape(lay["gate_proj"])[-1]
        return dict(num_layers=int(L), hidden_size=int(H),
                    intermediate_size=int(inter), head_dim=int(head_dim),
                    num_heads=int(q_dim // head_dim),
                    num_kv_heads=int(kv_dim // head_dim))

    t, c = params["talker"], params["code_predictor"]
    talker = dataclasses.replace(
        base.talker, **stack_geo(t),
        codec_vocab_size=int(t["codec_embedding"].shape[0]),
        text_vocab_size=int(t["text_embedding"].shape[0]),
        text_embed_dim=int(t["text_embedding"].shape[1]))
    heads = shape(c["lm_heads"])
    cp = dataclasses.replace(
        base.code_predictor, **stack_geo(c), num_groups=int(heads[0]),
        group_vocab_size=int(heads[2]), max_seq_len=int(heads[0]) + 1)
    return dataclasses.replace(base, talker=talker, code_predictor=cp)


def load_from_hf_checkpoint(model_dir: str, cfg: TTSConfig,
                            dtype=torch.bfloat16,
                            timings: Optional[Dict[str, float]] = None,
                            ) -> Params:
    timings = {} if timings is None else timings
    """The talker and the code predictor from ``model_dir/
    model.safetensors``, on the host."""
    with stage(timings, "read"):
        weights = read_safetensors(os.path.join(model_dir,
                                                "model.safetensors"))
    with stage(timings, "map"):
        return {
            "talker": load_talker_from_hf(weights, cfg.talker, dtype),
            "code_predictor": load_code_predictor_from_hf(
                weights, cfg.code_predictor, dtype),
        }


def load_params(model_dir: Optional[str], cfg: TTSConfig,
                dtype=torch.bfloat16, seed: int = 0, device="cpu",
                timings: Optional[Dict[str, float]] = None) -> Params:
    """Weights for ``model_dir``, on ``device``:

    - None: random, drawn on ``device`` from ``seed`` (init_random_params);
    - a directory with ``params.npz``: that file (either package's),
      talker and code-predictor floats cast to ``dtype`` (QTensors and
      the f32 vocoder and encoder as they are);
    - else ``model.safetensors`` (the talker and the code predictor in
      ``dtype``) with the vocoder and encoder from
      ``speech_tokenizer/model.safetensors``, or else from
      ``vocoder.npz`` (and ``encoder.npz``) beside it; with neither, a
      warning and a random vocoder from ``seed``.

    A checkpoint is read and mapped on the host, then moved once;
    ``timings``, if given, gets the seconds of "read", "map" and
    "to_device"."""
    if model_dir is None:
        return init_random_params(cfg, seed, dtype, device)
    timings = {} if timings is None else timings
    native = os.path.join(model_dir, "params.npz")
    if os.path.exists(native):
        with stage(timings, "read"):
            params = load_pytree_npz(native)
        with stage(timings, "map"):
            if dtype is not None:
                params.update(_map_tree(
                    {k: params[k] for k in ("talker", "code_predictor")
                     if k in params},
                    lambda t: t.to(dtype) if t.is_floating_point() else t,
                    lambda w: w))
    else:
        params = load_from_hf_checkpoint(model_dir, cfg, dtype, timings)
        st_dir = os.path.join(model_dir, "speech_tokenizer")
        voc_native = os.path.join(model_dir, "vocoder.npz")
        enc_native = os.path.join(model_dir, "encoder.npz")
        if os.path.exists(os.path.join(st_dir, "model.safetensors")):
            params.update(load_speech_tokenizer(st_dir, cfg, timings))
        elif os.path.exists(voc_native):
            with stage(timings, "read"):
                params["vocoder"] = load_pytree_npz(voc_native,
                                                    torch.float32)
                if os.path.exists(enc_native):
                    params["encoder"] = load_pytree_npz(enc_native,
                                                        torch.float32)
        else:
            warnings.warn(
                f"{model_dir} has neither speech_tokenizer/model.safetensors "
                "nor vocoder.npz: the vocoder is RANDOMLY INITIALIZED and "
                "synthesis will emit noise, not speech. Provide the "
                "checkpoint's speech_tokenizer/ directory or run "
                "qwen3_tts_tpu_torch.tools.convert_weights "
                "--speech_tokenizer.", stacklevel=2)
            params["vocoder"] = init_vocoder_params(cfg.vocoder, seed)
    with stage(timings, "to_device"):
        params = to_device(params, device)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
    return params
