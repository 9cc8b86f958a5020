"""int8 quality dossier of the port: greedy code agreement, hidden cosine
and audio SNR of the quantized tiers against the bf16 baseline. Twin of
the JAX package's tools/quality_check.py (its method, flags, metrics and
JSON keys), over the port's own talker and code predictor.

    python -m qwen3_tts_tpu_torch.tools.quality_check [--tiny]
        [--device cuda|cpu] [--variants int8,int8-cp] [--hidden_steps 64]
        [--max_tokens N] [--texts T ...] [--seed 0] [--model_dir DIR]

Method (the JAX tool's): decode the same prompts GREEDILY (temperature
1e-6: sampling collapses to the argmax, so any difference is
quantization error, not sampling noise) under bf16 and each quantized
variant, then compare:

- free-running code agreement: the share of code_0s and of whole
  16-code rows equal by position, and the divergence-free prefix
  fraction (after the first differing row the feedback differs);
- teacher-forced agreement: the variant re-decodes the bf16 trajectory
  with the bf16 codes forced as feedback, so every step sees the
  baseline's context; tf_code0 / tf_row are per-step flip rates, and
  tf_cos_min the least cosine between the two hiddens each decision was
  made from;
- hidden cosine over the agreeing prefix (and the first divergent step);
- audio SNR (dB) of each variant's vocoded codes against the bf16 audio
  over the common length; the vocoder is f32 in both, so the audio
  differs only through the codes.

The trajectories step through models/talker and models/code_predictor
with the engine's own weights, so on the card they run the kernels the
engine serves with: int8 the fused talker step (K3), the code
predictor's steps (K2) and the int8 products (K1); int8-cp K2 and K1
over the dense talker. One JSON line on stdout; a table on stderr.
``--tiny`` is the tiny geometry (seconds on the CPU with ``--device
cpu``); the default is the full 0.6B geometry on the card, random
weights unless ``--model_dir``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

DEFAULT_TEXTS = (
    "Привет, мир! Это проверка качества квантования.",
    "The quick brown fox jumps over the lazy dog.",
    "Синтез речи на TPU работает быстро и точно.",
)


def greedy_config(cfg):
    """The sampling config with temperature -> 0 (1e-6): top-k keeps the
    argmax with probability ~1, and so does the code predictor's draw;
    the decode is deterministic, whatever the key. EOS pacing, boost and
    repetition penalty stay (they are part of the numerics compared)."""
    scfg = dataclasses.replace(cfg.sampling, temperature=1e-6,
                               cp_temperature=1e-6)
    return dataclasses.replace(cfg, sampling=scfg)


def build_engine(cfg, params: dict, quantize: Optional[str], device="cuda",
                 dtype=torch.bfloat16):
    from qwen3_tts_tpu_torch.engine.engine import TTSEngine

    # dict() copy: TTSEngine replaces entries when it quantizes, and each
    # variant starts from the same bf16 tree
    return TTSEngine(cfg=cfg, params=dict(params), quantize=quantize,
                     device=device, dtype=dtype)


def _start(engine, text: str, seed: int):
    """The request's post-prefill state (a copy the loop may update in
    place), the tts_pad embedding and the rope table, as run_steps
    builds them."""
    from qwen3_tts_tpu_torch.config import TTS_PAD_TOKEN_ID
    from qwen3_tts_tpu_torch.models import talker as tk
    from qwen3_tts_tpu_torch.models import transformer as tfm

    ids, n_text = engine._encode_text(text)
    state = engine._prefill(ids, n_text, seed, engine.cfg.max_tokens)
    dev = engine.device
    tts_pad = tk.embed_text(engine._tp, torch.tensor([TTS_PAD_TOKEN_ID],
                                                     device=dev))[0]
    tcfg = engine.cfg.talker
    rope = tfm.rope_cos_sin(torch.arange(state.kv.shape[3], device=dev),
                            tcfg.head_dim, tcfg.rope_theta)
    return state, tts_pad, rope


@torch.inference_mode()
def hidden_trajectory(engine, text: str, seed: int, n_steps: int):
    """Greedy-decode ``n_steps`` tokens through engine/generate's
    ``_loop_body`` (the served decode), keeping the talker hidden each
    code_0 was sampled from (step 0: the post-prefill hidden). Returns
    (hiddens (n_steps, H) f32, codes (max_tokens, 16), n_codes)."""
    from qwen3_tts_tpu_torch.engine import generate as gen

    state, tts_pad, rope = _start(engine, text, seed)
    hs = []
    for _ in range(n_steps):
        hs.append(state.hidden[0].float())
        state = gen._loop_body(state, engine._tp, engine._cpp, tts_pad,
                               engine.cfg, rope_table=rope)
    return (torch.stack(hs).cpu().numpy(), state.codes[0].cpu().numpy(),
            int(state.n_codes[0]))


@torch.inference_mode()
def teacher_forced_trajectory(engine, text: str, seed: int,
                              ref_codes: np.ndarray):
    """Re-decode ``len(ref_codes)`` steps with the reference codes forced
    as feedback and ring context, recording what this engine would have
    chosen greedily at each step. _loop_body's sequence (codec_logits ->
    sample_code0 -> predict_codes -> feedback -> decode_step) with the
    commit swapped for the forced row. Returns (hiddens (T, H) f32, the
    hidden each decision was made from, and the chosen (T, 16) codes)."""
    from qwen3_tts_tpu_torch.models import code_predictor as cp
    from qwen3_tts_tpu_torch.models import talker as tk
    from qwen3_tts_tpu_torch.ops import sampling as smp

    cfg = engine.cfg
    scfg = cfg.sampling
    tp, cpp = engine._tp, engine._cpp
    s, tts_pad, rope = _start(engine, text, seed)
    forced = torch.as_tensor(np.asarray(ref_codes, np.int64),
                             device=engine.device)
    embs = cpp["codec_embs"]
    g_idx = torch.arange(embs.shape[0], device=embs.device)
    hs, rows = [], []
    for ref_row in forced:
        logits = tk.codec_logits(tp, s.hidden)
        seeds = smp.token_seeds(s.key, s.n_codes)
        code0_var = smp.sample_code0(logits, s.ring, s.n_codes, s.n_text,
                                     seeds[:, smp.SITE_CODE0], scfg)
        ref0 = ref_row[:1]
        c0_embed = tp["codec_embedding"][ref0]           # forced input
        groups_var = cp.predict_codes(cpp, s.hidden, c0_embed,
                                      seeds[:, smp.SITE_CP_GROUP1:],
                                      cfg.code_predictor, scfg)
        fb = (c0_embed + embs[g_idx, ref_row[1:]].sum(dim=0)[None]
              + tts_pad[None, :]).to(s.hidden.dtype)
        hidden, kv = tk.decode_step(tp, fb, s.pos, s.kv, cfg.talker,
                                    rope_table=rope)
        hs.append(s.hidden[0].float())
        rows.append(torch.cat([code0_var[:1].to(groups_var.dtype),
                               groups_var[0]]))
        s = dataclasses.replace(
            s, kv=kv, pos=s.pos + 1, hidden=hidden,
            ring=smp.ring_push(s.ring, ref0.to(s.ring.dtype)),
            n_codes=s.n_codes + 1)
    return (torch.stack(hs).cpu().numpy(),
            torch.stack(rows).cpu().numpy().astype(np.int32))


def snr_db(ref: np.ndarray, test: np.ndarray) -> float:
    """SNR of ``test`` against ``ref`` (int16 arrays) over the common
    length, in dB."""
    m = min(len(ref), len(test))
    if m == 0:
        return float("inf")
    r = ref[:m].astype(np.float64)
    e = r - test[:m].astype(np.float64)
    num = float(np.sum(r * r))
    den = float(np.sum(e * e))
    if den == 0.0:
        return float("inf")
    if num == 0.0:
        return 0.0
    return 10.0 * np.log10(num / den)


def _cos_rows(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a, b = a.astype(np.float64), b.astype(np.float64)
    return (np.sum(a * b, axis=1)
            / np.maximum(np.linalg.norm(a, axis=1)
                         * np.linalg.norm(b, axis=1), 1e-30))


def compare_variant(eng_ref, eng_var, texts: Sequence[str], seed: int,
                    n_hidden_steps: int) -> Dict:
    """Per-text greedy comparison of ``eng_var`` against ``eng_ref``;
    the aggregated metrics (worst-case minima and means), the JAX
    tool's."""
    rows: List[Dict] = []
    for ti, text in enumerate(texts):
        hs_r, codes_r, n_r = hidden_trajectory(eng_ref, text, seed,
                                               n_hidden_steps)
        hs_v, codes_v, n_v = hidden_trajectory(eng_var, text, seed,
                                               n_hidden_steps)
        m = min(n_r, n_v)
        row_eq = (codes_r[:m] == codes_v[:m]).all(axis=1)
        code0_eq = codes_r[:m, 0] == codes_v[:m, 0]
        # divergence-free prefix: the tokens before the first differing row
        prefix = int(np.argmin(row_eq)) if not row_eq.all() else m
        # hidden cosine over the agreeing prefix and the first divergent
        # step (the inputs are equal up to and including hidden[prefix])
        k = min(prefix + 1, min(len(hs_r), len(hs_v)), m + 1)
        cos = _cos_rows(hs_r[:k], hs_v[:k]) if k > 0 else np.ones((0,))
        hs_tf, rows_tf = teacher_forced_trajectory(eng_var, text, seed,
                                                   codes_r[:n_r])
        tf_code0 = rows_tf[:, 0] == codes_r[:n_r, 0]
        tf_row = (rows_tf == codes_r[:n_r]).all(axis=1)
        kt = min(len(hs_tf), len(hs_r), n_r)
        tf_cos = _cos_rows(hs_r[:kt], hs_tf[:kt])
        # audio through each variant's own codes (the vocoder is f32)
        audio_r = eng_ref.vocode(codes_r[:n_r])
        audio_v = eng_var.vocode(codes_v[:n_v])
        ma = min(len(audio_r), len(audio_v))
        rows.append({
            "text_idx": ti,
            "n_ref": n_r,
            "n_var": n_v,
            "code0_agree": float(code0_eq.mean()) if m else 1.0,
            "row_agree": float(row_eq.mean()) if m else 1.0,
            "prefix_frac": (prefix / n_r) if n_r else 1.0,
            "tf_code0_agree": float(tf_code0.mean()) if n_r else 1.0,
            "tf_row_agree": float(tf_row.mean()) if n_r else 1.0,
            "tf_cos_min": float(tf_cos.min()) if kt else 1.0,
            "hidden_cos_min": float(cos.min()) if len(cos) else 1.0,
            "hidden_cos_mean": float(cos.mean()) if len(cos) else 1.0,
            "snr_db": snr_db(audio_r, audio_v),
            "int16_match": (float((audio_r[:ma] == audio_v[:ma]).mean())
                            if ma else 1.0),
        })
    return {
        "code0_agree": float(np.mean([r["code0_agree"] for r in rows])),
        "row_agree": float(np.mean([r["row_agree"] for r in rows])),
        "prefix_frac": float(np.mean([r["prefix_frac"] for r in rows])),
        "tf_code0_agree": float(np.mean([r["tf_code0_agree"]
                                         for r in rows])),
        "tf_row_agree": float(np.mean([r["tf_row_agree"] for r in rows])),
        "tf_cos_min": float(min(r["tf_cos_min"] for r in rows)),
        "hidden_cos_min": float(min(r["hidden_cos_min"] for r in rows)),
        "hidden_cos_mean": float(np.mean([r["hidden_cos_mean"]
                                          for r in rows])),
        "snr_db_min": float(min(r["snr_db"] for r in rows)),
        "int16_match": float(np.mean([r["int16_match"] for r in rows])),
        "len_match": all(r["n_ref"] == r["n_var"] for r in rows),
        "texts": rows,
    }


def run_dossier(cfg, params, variants: Sequence[str],
                texts: Sequence[str], seed: int, n_hidden_steps: int,
                device="cuda") -> Dict:
    eng_ref = build_engine(cfg, params, None, device)
    report: Dict[str, Dict] = {}
    for v in variants:
        eng_var = build_engine(cfg, params, v, device)
        report[v] = compare_variant(eng_ref, eng_var, texts, seed,
                                    n_hidden_steps)
        del eng_var
    return report


SUMMARY_KEYS = ("tf_code0_agree", "tf_row_agree", "tf_cos_min",
                "code0_agree", "row_agree", "prefix_frac", "hidden_cos_min",
                "hidden_cos_mean", "snr_db_min", "int16_match", "len_match")


def summary_line(report: Dict, geometry: str, weights: str, seed: int,
                 n_texts: int) -> str:
    """The JSON line of a dossier (JSON has no inf: an infinite SNR is
    null; the table on stderr says "inf")."""
    out = {"geometry": geometry, "weights": weights, "seed": seed,
           "n_texts": n_texts}
    for v, a in report.items():
        out[v] = {k: a[k] for k in SUMMARY_KEYS}
    return json.dumps(out, default=str).replace("Infinity", "null")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model_dir", default=None,
                    help="checkpoint dir (random weights if absent)")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny geometry (seconds on the CPU)")
    ap.add_argument("--variants", default="int8,int8-cp")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max_tokens", type=int, default=None)
    ap.add_argument("--hidden_steps", type=int, default=64,
                    help="greedy steps captured for the cosine trace")
    ap.add_argument("--texts", nargs="*", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from qwen3_tts_tpu_torch.config import TTSConfig, tiny_tts_config
    from qwen3_tts_tpu_torch.io import weights as weights_io

    if args.tiny:
        cfg = tiny_tts_config(max_tokens=args.max_tokens or 24)
    else:
        cfg = TTSConfig()
        if args.max_tokens:
            cfg = dataclasses.replace(cfg, max_tokens=args.max_tokens)
    cfg = greedy_config(cfg)
    params = weights_io.load_params(args.model_dir, cfg, torch.bfloat16,
                                    seed=0, device=args.device)
    texts = args.texts or list(DEFAULT_TEXTS)
    variants = [v for v in args.variants.split(",") if v]
    n_hidden = min(args.hidden_steps, cfg.max_tokens)

    report = run_dossier(cfg, params, variants, texts, args.seed, n_hidden,
                         args.device)

    print(f"{'variant':10} {'tf_c0%':>7} {'tf_row%':>8} {'code0%':>7} "
          f"{'row%':>7} {'prefix%':>8} {'cos_min':>8} {'tf_cos':>8} "
          f"{'SNR dB':>8} {'i16%':>7}", file=sys.stderr)
    for v, a in report.items():
        snr = "inf" if np.isinf(a["snr_db_min"]) else f"{a['snr_db_min']:.1f}"
        print(f"{v:10} {100*a['tf_code0_agree']:6.1f}%"
              f" {100*a['tf_row_agree']:7.1f}%"
              f" {100*a['code0_agree']:6.1f}% {100*a['row_agree']:6.1f}%"
              f" {100*a['prefix_frac']:7.1f}% {a['hidden_cos_min']:8.5f}"
              f" {a['tf_cos_min']:8.5f} {snr:>8}"
              f" {100*a['int16_match']:6.1f}%", file=sys.stderr)
    print(summary_line(report, "tiny" if args.tiny else "real",
                       "checkpoint" if args.model_dir else "random",
                       args.seed, len(texts)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
