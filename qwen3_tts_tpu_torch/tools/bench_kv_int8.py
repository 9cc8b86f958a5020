"""int8-KV probe of the batched talker decode on the port; twin of the JAX
package's tools/dev/bench_kv_int8.py.

Question: the batched talker's KV read grows with the batch (~117 MB a
row a step at S=512, full geometry, bf16). Does a per-row scaled int8 KV
cache -- quantized at append, dequantized in registers inside K6
(ops/kernels/kv_int8.py) -- make a decode step faster at batch 4 and 8?

Method (the JAX tool's): one process, interleaved trials of two talker
decode loops that differ only in the KV cache: the bf16 cache under
models/transformer.decode_step (attention as the config's
``attention_impl`` says), against the int8 cache through
``decode_step_kv8`` with K6. Both loops start from the same 40-position
history (the int8 cache quantized from the bf16 one) and consume the same
input sequence, so the per-step hidden cosine between the two
trajectories bounds what the int8 cache perturbs. A loop runs REP steps;
its time is the host clock around them, closed by a device synchronise,
and the median over trials is reported per step.

    python -m qwen3_tts_tpu_torch.tools.bench_kv_int8 [REP] [trials] \\
        [--device cuda] [--tiny]

``--tiny`` runs config.tiny_tts_config() (``--device cpu`` then takes
seconds); the default is TTSConfig(), the full 0.6B talker geometry.
"""

from __future__ import annotations

import argparse
import statistics
import time

import torch

from qwen3_tts_tpu_torch.config import TTSConfig, tiny_tts_config
from qwen3_tts_tpu_torch.io.weights import init_random_params
from qwen3_tts_tpu_torch.models import transformer as tfm
from qwen3_tts_tpu_torch.ops import quant
from qwen3_tts_tpu_torch.ops.kernels.kv_int8 import (decode_attention_kv_int8,
                                                     quantize_kv_rows)
from qwen3_tts_tpu_torch.tools import log, log_device, sync

HISTORY = 40          # prefill-like positions already in the cache
SEED = 0              # weights, history and inputs


def decode_step_kv8(layers: dict, x: torch.Tensor, pos: torch.Tensor,
                    cache, geo: tfm.TransformerGeometry):
    """The JAX tool's int8-KV talker decode step (its closure
    ``decode_step_kv8``). x (B, H); pos (B,); cache = (kq, ks, vq, vs):
    (L, B, Hkv, S, Dh) int8 and (L, B, Hkv, S) f32, contiguous. Per layer:
    q|k|v, the new k and v rows quantized and written at (b, h, pos[b]) IN
    PLACE (as models/transformer.decode_step writes its cache), attention
    on K6, o_proj, then the MLP. Returns (hidden (B, H) before the final
    norm, cache)."""
    kq, ks, vq, vs = cache
    B = x.shape[0]
    pos = pos.long()
    cos, sin = tfm.rope_cos_sin(pos[:, None], geo.head_dim, geo.rope_theta)
    b_idx = torch.arange(B, device=x.device)[:, None]
    h_idx = torch.arange(geo.num_kv_heads, device=x.device)[None, :]
    p_idx = pos[:, None]
    h = x
    for li, layer in enumerate(tfm._layers(layers)):
        hn = tfm.rms_norm(h, layer["input_ln"], geo.rms_norm_eps)
        q, k, v = tfm._qkv(layer, hn[:, None, :], geo, cos, sin)
        for cq, cs, new in ((kq, ks, k), (vq, vs, v)):
            nq, ns = quantize_kv_rows(new[:, 0])             # (B, Hkv, Dh)
            cq[li, b_idx, h_idx, p_idx] = nq
            cs[li, b_idx, h_idx, p_idx] = ns
        attn = decode_attention_kv_int8(q[:, 0], kq[li], ks[li], vq[li],
                                        vs[li], pos)
        h = h + quant.matmul(attn, layer["o_proj"]).to(h.dtype)
        hn = tfm.rms_norm(h, layer["post_ln"], geo.rms_norm_eps)
        h = h + tfm.swiglu_mlp(hn, layer.get("gate_proj"),
                               layer.get("up_proj"), layer["down_proj"],
                               gateup_w=layer.get("gateup_proj"))
    return h, cache


def bf16_loop(layers, xs, kv, pos0, geo) -> torch.Tensor:
    """len(xs) steps of models/transformer.decode_step over the dense cache
    kv (written in place); the hidden of every step (T, B, H)."""
    pos, hs = pos0, []
    for x in xs:
        h, kv = tfm.decode_step(layers, x, pos, kv, geo)
        hs.append(h)
        pos = pos + 1
    return torch.stack(hs)


def int8_loop(layers, xs, cache, pos0, geo) -> torch.Tensor:
    """len(xs) steps of decode_step_kv8 over the int8 cache (written in
    place); the hidden of every step (T, B, H)."""
    pos, hs = pos0, []
    for x in xs:
        h, cache = decode_step_kv8(layers, x, pos, cache, geo)
        hs.append(h)
        pos = pos + 1
    return torch.stack(hs)


@torch.inference_mode()
def run(cfg: TTSConfig, batches=(4, 8), rep: int = 32, trials: int = 6,
        device="cuda") -> dict:
    """The probe at each batch size: {B: {"cos_min", "cos_last", "bf16_ms",
    "int8kv_ms", "bf16_min_ms", "int8kv_min_ms"}} (ms per step; the
    medians and minima over ``trials``)."""
    dev = torch.device(device)
    tcfg = cfg.talker
    geo = tfm.geometry_of(tcfg)
    if HISTORY + rep > tcfg.max_seq_len:
        raise ValueError(f"{HISTORY} + {rep} steps exceed max_seq_len "
                         f"{tcfg.max_seq_len}")
    layers = init_random_params(cfg, SEED, torch.bfloat16,
                                dev)["talker"]["layers"]
    L, S, Hkv, Dh, H = (tcfg.num_layers, tcfg.max_seq_len,
                        tcfg.num_kv_heads, tcfg.head_dim, tcfg.hidden_size)
    log_device(dev)
    results = {}
    for B in batches:
        g = torch.Generator(device=dev).manual_seed(SEED)
        kv0 = (torch.randn((L, 2, B, S, Hkv, Dh), generator=g, device=dev)
               * 0.02).to(torch.bfloat16)
        kv0[:, :, :, HISTORY:] = 0
        cache0 = []
        for i in (0, 1):
            cq, cs = quantize_kv_rows(kv0[:, i].transpose(2, 3).contiguous())
            cache0 += [cq.contiguous(), cs.contiguous()]
        g = torch.Generator(device=dev).manual_seed(SEED + 1)
        xs = (torch.randn((rep, B, H), generator=g, device=dev)
              * 0.05).to(torch.bfloat16)
        pos0 = torch.full((B,), HISTORY, dtype=torch.long, device=dev)

        def go(name):
            if name == "bf16":
                return bf16_loop(layers, xs, kv0.clone(), pos0, geo)
            return int8_loop(layers, xs, tuple(t.clone() for t in cache0),
                             pos0, geo)

        a = go("bf16").double().reshape(rep, -1).cpu()
        b = go("int8kv").double().reshape(rep, -1).cpu()
        cos_t = (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1) + 1e-30)
        row = {"cos_min": float(cos_t.min()), "cos_last": float(cos_t[-1])}
        log(f"B={B}: hidden cosine min {row['cos_min']:.6f} "
            f"last {row['cos_last']:.6f}")

        times = {"bf16": [], "int8kv": []}
        for _ in range(trials):
            for name in times:
                sync(dev)
                t0 = time.perf_counter()
                go(name)
                sync(dev)
                times[name].append((time.perf_counter() - t0) * 1e3 / rep)
        for name, ts in times.items():
            if ts:
                row[f"{name}_ms"] = statistics.median(ts)
                row[f"{name}_min_ms"] = min(ts)
                log(f"B={B} {name}: {row[f'{name}_ms']:.3f} ms/step "
                    f"(min {min(ts):.3f})")
        if times["bf16"]:
            d = (row["bf16_ms"] - row["int8kv_ms"]) / row["bf16_ms"] * 100
            log(f"B={B}: int8 KV delta {d:+.1f}% vs bf16")
        results[B] = row
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rep", nargs="?", type=int, default=32)
    ap.add_argument("trials", nargs="?", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help="config.tiny_tts_config() instead of TTSConfig()")
    args = ap.parse_args(argv)
    cfg = tiny_tts_config() if args.tiny else TTSConfig()
    run(cfg, rep=args.rep, trials=args.trials, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
