"""Seeded random weights for a configuration, made on the device in a few
large draws, in the port's parameter layout (the names, shapes and
(in, out) orientation of ``qwen3_tts_tpu_torch/io/weights.py``) and at its
scales: N(0, 0.02) projections and embeddings in the served type, unit
norms, zero biases; uniform +-1/sqrt(fan_in) float32 vocoder weights.

Every leaf is a view into one buffer per kind (normal, uniform), so a
configuration's weights cost two random draws whatever its depth. Both
the program and the reference are handed the same tree; neither gets
anything the other derived from it."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

NORMAL_SCALE = 0.02


def _stack(L: int, H: int, I: int, QD: int, KVD: int, Dh: int) -> dict:
    return {"input_ln": ("ones", (L, H)), "q_proj": ("normal", (L, H, QD)),
            "k_proj": ("normal", (L, H, KVD)),
            "v_proj": ("normal", (L, H, KVD)),
            "o_proj": ("normal", (L, QD, H)), "q_norm": ("ones", (L, Dh)),
            "k_norm": ("ones", (L, Dh)), "post_ln": ("ones", (L, H)),
            "gate_proj": ("normal", (L, H, I)),
            "up_proj": ("normal", (L, H, I)),
            "down_proj": ("normal", (L, I, H))}


def _geo_stack(c: dict) -> dict:
    return _stack(c["num_layers"], c["hidden_size"], c["intermediate_size"],
                  c["num_heads"] * c["head_dim"],
                  c["num_kv_heads"] * c["head_dim"], c["head_dim"])


def layout(cfg: dict) -> dict:
    """The weight tree of a configuration file's dict as (kind, shape)
    leaves; kinds: normal, uniform (fan_in), ones, zeros, full (value)."""
    t, c, v = cfg["talker"], cfg["code_predictor"], cfg["vocoder"]
    E, H = t["text_embed_dim"], t["hidden_size"]
    talker = {"layers": _geo_stack(t), "final_norm": ("ones", (H,)),
              "text_embedding": ("normal", (t["text_vocab_size"], E)),
              "proj_fc1_w": ("normal", (E, E)), "proj_fc1_b": ("zeros", (E,)),
              "proj_fc2_w": ("normal", (E, H)), "proj_fc2_b": ("zeros", (H,)),
              "codec_embedding": ("normal", (t["codec_vocab_size"], H)),
              "codec_head": ("normal", (H, t["codec_vocab_size"]))}
    Hc, G, V = c["hidden_size"], c["num_groups"], c["group_vocab_size"]
    cp = {"layers": _geo_stack(c), "final_norm": ("ones", (Hc,)),
          "mtp_proj_w": ("normal", (Hc, Hc)), "mtp_proj_b": ("zeros", (Hc,)),
          "codec_embs": ("normal", (G, V, Hc)),
          "lm_heads": ("normal", (G, Hc, V))}
    return {"talker": talker, "code_predictor": cp, "vocoder": _vocoder(v)}


def _vocoder(v: dict) -> dict:
    H, I, L = v["hidden_size"], v["intermediate_size"], v["num_hidden_layers"]
    u = lambda *s, fan=None: ("uniform", s, fan)  # noqa: E731
    layers = {"input_ln": ("ones", (L, H)), "post_ln": ("ones", (L, H)),
              "q_proj": u(L, H, H), "k_proj": u(L, H, H),
              "v_proj": u(L, H, H), "o_proj": u(L, H, H),
              "gate_proj": u(L, H, I), "up_proj": u(L, H, I),
              "down_proj": u(L, I, H),
              "attn_scale": ("full", (L, H), v["layer_scale_initial_scale"]),
              "mlp_scale": ("full", (L, H), v["layer_scale_initial_scale"])}
    p = {"code_embedding": u(v["num_codebooks"] * v["codebook_size"], H,
                             fan=H),
         "pre": {"layers": layers, "norm": ("ones", (H,))},
         "upsample": {}, "blocks": {}}
    for i, f in enumerate(v["upsampling_ratios"]):
        p["upsample"][str(i)] = {
            "up_w": u(f, H, H), "up_b": ("zeros", (H,)),
            "cn_dw_w": u(7, 1, H), "cn_dw_b": ("zeros", (H,)),
            "cn_ln_w": ("ones", (H,)), "cn_ln_b": ("zeros", (H,)),
            "cn_pw1_w": u(H, 4 * H), "cn_pw1_b": ("zeros", (4 * H,)),
            "cn_pw2_w": u(4 * H, H), "cn_pw2_b": ("zeros", (H,)),
            "cn_gamma": ("full", (H,), 1e-6)}
    D = v["decoder_dim"]
    p["dec_in_w"], p["dec_in_b"] = u(7, H, D), ("zeros", (D,))
    cin = D
    for i, r in enumerate(v["upsample_rates"]):
        cout = D // (2 ** (i + 1))
        blk = {"alpha": ("zeros", (cin,)), "beta": ("zeros", (cin,)),
               "up_w": u(2 * r, cin, cout), "up_b": ("zeros", (cout,)),
               "res": {}}
        for d in range(3):
            blk["res"][str(d)] = {
                "alpha1": ("zeros", (cout,)), "beta1": ("zeros", (cout,)),
                "conv1_w": u(7, cout, cout), "conv1_b": ("zeros", (cout,)),
                "alpha2": ("zeros", (cout,)), "beta2": ("zeros", (cout,)),
                "conv2_w": u(1, cout, cout), "conv2_b": ("zeros", (cout,))}
        p["blocks"][str(i)] = blk
        cin = cout
    p["out_alpha"], p["out_beta"] = ("zeros", (cin,)), ("zeros", (cin,))
    p["out_w"], p["out_b"] = u(7, cin, 1), ("zeros", (1,))
    return p


def _leaves(tree: dict, path=()) -> List[Tuple[tuple, tuple]]:
    out = []
    for k, node in tree.items():
        if isinstance(node, dict):
            out += _leaves(node, path + (k,))
        else:
            out.append((path + (k,), node))
    return out


def _put(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def make(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> Dict[str,
                                                                     dict]:
    """The weights of configuration ``cfg`` from ``seed`` on ``device``:
    talker and code predictor in ``dtype`` (the served type of their
    dense weights), the vocoder in float32. One normal and one uniform
    draw from a torch.Generator on the device, each leaf a view. The
    configuration's ``weights`` group may set ``vocoder_out_gain``, a
    factor on the vocoder's output conv that brings the waveform of
    random weights to a speech level."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed) % (2 ** 63))
    leaves = _leaves(layout(cfg))
    out: Dict[str, dict] = {}
    normal = [(p, s) for p, (k, s, *_r) in leaves if k == "normal"]
    uniform = [(p, s, r[0]) for p, (k, s, *r) in leaves if k == "uniform"]
    n_normal = sum(math.prod(s) for _p, s in normal)
    gain = float(cfg.get("weights", {}).get("vocoder_out_gain", 1.0))
    buf = torch.randn(n_normal, generator=gen, device=dev,
                      dtype=dtype).mul_(NORMAL_SCALE)
    off = 0
    for path, shape in normal:
        n = math.prod(shape)
        _put(out, path, buf[off:off + n].view(shape))
        off += n
    n_uniform = sum(math.prod(s) for _p, s, _f in uniform)
    ubuf = torch.rand(n_uniform, generator=gen, device=dev)
    off = 0
    for path, shape, fan in uniform:
        n = math.prod(shape)
        f = fan if fan is not None else math.prod(shape[:-1])
        s = 1.0 / math.sqrt(max(f, 1))
        if path == ("vocoder", "out_w"):
            s *= gain
        ubuf[off:off + n].mul_(2 * s).sub_(s)
        _put(out, path, ubuf[off:off + n].view(shape))
        off += n
    f32 = dict(dtype=torch.float32, device=dev)
    for path, (kind, shape, *rest) in leaves:
        comp_dtype = torch.float32 if path[0] == "vocoder" else dtype
        if kind == "ones":
            _put(out, path, torch.ones(shape, dtype=comp_dtype, device=dev))
        elif kind == "zeros":
            _put(out, path, torch.zeros(shape, dtype=comp_dtype, device=dev))
        elif kind == "full":
            _put(out, path, torch.full(shape, rest[0], **f32))
    return out
