"""The plain reference (benchmark/reference/model.py) against the port's
CPU path at tiny_tts_config(), in float32: the talker's logits over a
prefix and served tokens, the code-0 transforms, the code predictor's
greedy groups, and the vocoder's waveform."""

import dataclasses

import numpy as np
import torch

from benchmark import weights as W
from benchmark.reference import model as M


def _setup(seed=3):
    from qwen3_tts_tpu_torch import config as C
    cfg = C.tiny_tts_config(max_tokens=24)
    cfg = dataclasses.replace(cfg, sampling=dataclasses.replace(
        cfg.sampling, temperature=0.0, cp_temperature=0.0))
    d = dataclasses.asdict(cfg)
    params = W.make(d, seed, "cpu", dtype=torch.float32)
    return cfg, d, params


def test_talker_logits_and_code0_transforms():
    from qwen3_tts_tpu_torch.models import talker as tk
    from qwen3_tts_tpu_torch.models import transformer as tfm
    from qwen3_tts_tpu_torch.ops import sampling as smp
    cfg, d, params = _setup()
    g = np.random.default_rng(0)
    ids = torch.tensor(g.integers(0, 151643, 7), dtype=torch.int32)
    codes = torch.tensor(g.integers(0, 2048, (5, 16)), dtype=torch.int32)
    tp, cp = params["talker"], params["code_predictor"]
    prefix, plen = tk.build_prefix(tp, ids, 7)
    x = torch.cat([prefix[:int(plen)], tk.clone_frame_embeds(
        tp, cp["codec_embs"], codes)])[None]
    T = x.shape[1]
    geo = tfm.geometry_of(cfg.talker)
    h, _ = tfm.forward_prefill(tp["layers"], x, torch.arange(T)[None],
                               tfm.causal_mask(1, T, torch.tensor([T])),
                               geo)
    h = tfm.rms_norm(h, tp["final_norm"], cfg.talker.rms_norm_eps)[0]
    port = tk.codec_logits(tp, h[int(plen) - 1:])
    ref_w = M.prepare(params, "bfloat16", "bfloat16", "cpu")
    ref, hid = M.talker_forward(ref_w[0], ref_w[1], d["talker"], ids.long(),
                                codes)
    assert torch.allclose(ref, port, atol=1e-4, rtol=1e-4)
    # the greedy policy's transforms, step by step as the loop applies them
    c0 = codes[:, 0].long()
    scores, force = M.code0_scores(ref, torch.cat([c0, c0[:1]]), 7,
                                   d["sampling"])
    ring = torch.full((1, cfg.sampling.repetition_window), -1)
    for t in range(6):
        lg = smp.mask_code0_logits(ref[t:t + 1])
        lg, f = smp.eos_boost(lg, torch.tensor([t]), torch.tensor([7]),
                              cfg.sampling)
        lg = smp.repetition_penalty(lg, ring, cfg.sampling.repetition_penalty)
        assert torch.allclose(lg[0], scores[t]) and bool(f[0]) == bool(
            force[t])
        ring = smp.ring_push(ring, c0[t % 5:t % 5 + 1] if t < 5
                             else c0[:1])


def test_code_predictor_greedy_groups():
    from qwen3_tts_tpu_torch.models import code_predictor as cpm
    cfg, d, params = _setup(4)
    tp, cp = params["talker"], params["code_predictor"]
    g = torch.Generator().manual_seed(1)
    hidden = torch.randn((3, 64), generator=g)
    code0 = torch.tensor([5, 700, 2047])
    seeds = torch.zeros((3, 2), dtype=torch.int64)
    groups = cpm.predict_codes(cp, hidden, tp["codec_embedding"][code0],
                               seeds, cfg.code_predictor, cfg.sampling)
    codes = torch.cat([code0[:, None], groups.long()], 1)
    ref_w = M.prepare(params, "bfloat16", "bfloat16", "cpu")
    logits = M.cp_logits(ref_w[1], ref_w[0], d["code_predictor"], hidden,
                         codes)
    assert torch.equal(logits.argmax(-1), groups.long())


def test_vocoder_waveform():
    from qwen3_tts_tpu_torch.models import vocoder as voc
    cfg, d, params = _setup(5)
    codes = torch.tensor(np.random.default_rng(2).integers(0, 2048, (20, 16)))
    port = voc.decode_raw(params["vocoder"], codes[None], cfg.vocoder)[0]
    ref_w = M.prepare(params, "bfloat16", "bfloat16", "cpu")
    ref = M.vocoder(ref_w[2], d["vocoder"], codes)
    assert port.shape == ref.shape
    assert torch.allclose(port, ref, atol=1e-6, rtol=1e-4)


def test_quantize_matches_the_int8_rule():
    from qwen3_tts_tpu_torch.ops import quant
    w = torch.randn(32, 48)
    q = quant.quantize_int8(w)
    assert torch.equal(M.quantize(w, 8), q.q.float() * q.scale[None, :])
    four = M.quantize(w, 4)
    scale = w.abs().amax(0) / 7
    assert torch.all((four / scale).round().abs() <= 7)
