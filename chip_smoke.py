#!/usr/bin/env python3
"""Drive the PyTorch port (qwen3_tts_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

1. Set-up: the card (name, power limit), torch and CUDA versions; build
   the CUDA kernels from csrc/ (build seconds).
2. Kernels: each hand-written kernel against its plain PyTorch version on
   the card at the main paths' shapes (full 0.6B geometry, random
   weights): K1 qmatmul (both routes: grouped qsplit for decode rows, the
   qmm tile for prefill rows), K3 talker_step, K7 talker_step_merged (both
   variants, also against K3), K2 cp_decode, K5 decode_attention, K4
   paged_attention (also against K5 over the gathered rows, B = 4 and 8),
   K6 decode_attention_kv_int8, with the stated tolerances; the time of
   each beside its plain version's, its bound (bytes or operations at the
   card's published peaks) and, where one PyTorch call computes the same
   function, that call's time (K5 at the four shapes of
   qwen3_tts_tpu_torch/tools/bench_decode_attention). K3
   and K7 at B = 1, 4 and 8 with positions on the attention's chunk
   edges, bit for bit, and K3's time at B = 1, 4, 8
   (qwen3_tts_tpu_torch/tools/bench_talker_step). K2 at B = 1, 4 and 8:
   greedy tokens, the last step's logits and residual row bit for bit,
   its product alone against qmm at every width of a step, and its time
   (qwen3_tts_tpu_torch/tools/bench_cp_decode). Once every kernel is
   timed, K3's and K2's launches and per-kernel breakdown under
   torch.profiler (a profiler session slows later chains of dependent
   launches in the process by a few percent).
3. Slice: TTSEngine(TTSConfig(), quantize="int8") synthesizes three short
   texts; each request must give codes in range, n_tokens * 1920 finite
   samples, and launch K1 (on both routes), K2 and K3; K1 at most 23
   launches a decode step plus 4 a talker layer a request (the prefill).
4. Profile: one more request under torch.profiler, after the checked
   ones: device time by kernel, device busy time, launches per token.
5. Batcher: ContinuousBatcher (bf16 talker, int8 code predictor, 4 slots)
   serves 6 requests, dense with attention_impl="pallas" (K5), then paged
   (K4); each run twice, which must give equal codes (the paged rerun
   with its free pages handed out in reverse order), then one scheduler
   step of each under torch.profiler.
6. synthesize_batch: 3 texts in one batched decode (bf16, K5).
7. The port of tools/dev/bench_kv_int8.py (qwen3_tts_tpu_torch.tools.
   bench_kv_int8): the bf16 and the int8-KV talker decode loops (K6) at
   B = 4 and 8; the hidden cosine between them must stay >= 0.99.
8. The port of tools/dev/microbench_talker_merged.py: run_steps with the
   talker step swapped for K3, K7 merged and K7 mergedvec; equal codes,
   each variant launching its own kernel and no other.
9. One JSON line of per-kernel results, then the card line, then
   {"ok": true, "device": {...}} as the last line.

Every path is driven with the launch counters set to 0 just before it and
read just after; a kernel of the path that was not launched fails the
run. The launches of the kernels' comparisons are not counted.

Exits non-zero (and prints no result) without a CUDA device, outside a
checkout of the repository, or when any check fails.
"""

from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

TEXTS = ("Привет, мир!", "Hello from the port.", "Добрый день.")
BATCH_TEXTS = ("Привет, мир!", "Hello from the port.", "Добрый день.",
               "How are you today?", "Спасибо.", "A short one.")
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, published
F32_FLOPS = 67e12               # f32 outside the tensor cores, published


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def time_ms(*args, **kw) -> float:
    """qwen3_tts_tpu_torch.tools.time_ms (the checkout is on sys.path by
    the time a phase runs)."""
    from qwen3_tts_tpu_torch.tools import time_ms as timer
    return timer(*args, **kw)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def least_time(n_bytes: float, flops: float = 0.0,
               peak: float = F32_FLOPS):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    operations over the peak rate for their type."""
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = flops / peak * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def phase_qmatmul(card: str) -> dict:
    """K1 at the slice's shapes (tools/bench_qmatmul) against its plain
    version, error 0 on both routes (qsplit for decode rows, grouped; the
    qmm tile for prefill rows), each case on the route its shape picks;
    then the time of each case (CUDA-graph replay, weights from HBM) and,
    for codec_head, the plain version's, the bound and the library's
    int8 product."""
    import torch
    from qwen3_tts_tpu_torch.ops.kernels import qmatmul as tqm
    from qwen3_tts_tpu_torch.tools import bench_qmatmul
    g = torch.Generator(device="cuda").manual_seed(1)
    worst = 0.0
    for what, M, K, Ns in bench_qmatmul.CASES:
        x, ws = bench_qmatmul.inputs(g, M, K, Ns)
        route = "qsplit" if tqm.on_qsplit(M, K, Ns) else "qmm"
        n0 = (tqm.qmatmul_qsplit.launches, tqm.qmatmul_qmm.launches)
        got = tqm.qmatmul_group(x, ws)
        n1 = (tqm.qmatmul_qsplit.launches - n0[0],
              tqm.qmatmul_qmm.launches - n0[1])
        torch.cuda.synchronize()
        err = max(float((o - tqm.qmatmul_plain(x, q, s)).abs().max())
                  for o, (q, s) in zip(got, ws))
        print(f"K1 qmatmul {what} ({M},{K})x({K},{'|'.join(map(str, Ns))}) "
              f"[{route}, launches qsplit/qmm {n1}]: max_abs_err {err:.3e}")
        check(err == 0, f"K1 {what} disagrees with its plain version")
        check(n1 == ((1, 0) if route == "qsplit" else (0, len(Ns))),
              f"K1 {what}: launches {n1} on route {route}")
        worst = max(worst, err)
    rows = bench_qmatmul.run()
    for r in rows:
        print(f"  time {r['case']}: kernel {r['ms']:.5f} ms device (CUDA graph "
              f"replay, weights from HBM; {r['launches_a_call']} launches, "
              f"{r['weight_gb_s']:.0f} GB/s of int8 weights) [{card}]")
    M, K, N = 1, 1024, 3072
    x, [(q, s)] = bench_qmatmul.inputs(g, M, K, [N])
    qs = [q] + [q.clone() for _ in range((64 << 20) // (K * N))]
    nxt = itertools.cycle(qs).__next__
    t_p = time_ms(lambda: tqm.qmatmul_plain(x, nxt(), s), 50, graph=True)
    print(f"  plain codec_head: {t_p:.4f} ms [{card}]")
    b_ms, b_by = least_time(nbytes(x, q, s) + M * N * 4, 2.0 * M * K * N,
                            989e12)
    # the library's weight-only int8 product, where this torch has a CUDA
    # kernel for it: w (N, K) int8, bf16 scales
    lib = None
    try:
        qt, s16 = q.T.contiguous(), s.bfloat16()
        qs = [qt] + [qt.clone() for _ in range((64 << 20) // (K * N))]
        nxt = itertools.cycle(qs).__next__
        lib = time_ms(lambda: torch._weight_int8pack_mm(x, nxt(), s16), 50,
                      graph=True)
        del qs
    except (RuntimeError, AttributeError, NotImplementedError) as e:
        print(f"  torch._weight_int8pack_mm on CUDA: unavailable "
              f"({str(e).splitlines()[0][:120]})")
    print(f"  bound (1,1024)x(1024,3072): {b_ms:.5f} ms ({b_by}); library "
          f"_weight_int8pack_mm {lib} ms [{card}]")
    return {"name": "qmatmul", "route": "cuda",
            "source": "qwen3_tts_tpu_torch/csrc/qmatmul.cu",
            "replaces": "qwen3_tts_tpu/ops/pallas/qmatmul.py:48",
            "max_abs_err": worst, "ms": rows[0]["ms"],
            "plain_ms": t_p, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib,
            "shape": "(1,1024)x(1024,3072) on qsplit", "cases": rows}


# K3 and K7 check positions at S = 512: the attention's chunks are 64
# positions, so 0, 63, 64 and 511 sit on chunk edges
K3_POS = {1: [511], 4: [0, 63, 64, 511],
          8: [0, 63, 64, 511, 127, 128, 490, 37]}
# the cases K3 is timed and profiled at (tools/bench_talker_step)
K3_TIMED = [(f"B={B} pos 490", [490] * B) for B in (1, 4, 8)]


def phase_talker_step(eng, card: str) -> dict:
    """K3 on the engine's int8 talker against its plain version at B = 1,
    4 and 8 with positions on the attention's chunk edges: h and the
    fresh rows bit for bit, the scatter into the cache. Then
    tools/bench_talker_step at B = 1, 4, 8 (pos 490): the time under
    CUDA-graph replay and eager (its profile comes in
    phase_kernel_profiles)."""
    import torch
    from qwen3_tts_tpu_torch.models import transformer as tfm
    from qwen3_tts_tpu_torch.ops.kernels.talker_step import (
        talker_decode_step_fused, talker_step_cuda, talker_step_plain)
    from qwen3_tts_tpu_torch.tools import bench_talker_step
    cfg = eng.cfg.talker
    layers = eng._tp["layers"]
    S = cfg.max_seq_len
    cos, sin = tfm.rope_cos_sin(torch.arange(S, device="cuda"),
                                cfg.head_dim, cfg.rope_theta)
    eps = cfg.rms_norm_eps
    g = torch.Generator(device="cuda").manual_seed(3)
    worst = 0.0
    for B, p in K3_POS.items():
        x = (torch.randn((B, cfg.hidden_size), generator=g, device="cuda")
             * 0.1).bfloat16()
        kv = (torch.randn((cfg.num_layers, 2, B, S, cfg.num_kv_heads,
                           cfg.head_dim), generator=g, device="cuda")
              * 0.5).bfloat16()
        pos = torch.tensor(p, dtype=torch.int32, device="cuda")
        h_ref, rows_ref = talker_step_plain(layers, x, pos, kv, cos, sin, eps)
        kv_k = kv.clone()
        h_got, kv_k = talker_decode_step_fused(layers, x, pos, kv_k, cos, sin,
                                               eps=eps)
        _, rows_got = talker_step_cuda(layers, x, pos, kv, cos, sin, eps)
        torch.cuda.synchronize()
        err = max(float((h_got.float() - h_ref.float()).abs().max()),
                  float((rows_got - rows_ref).abs().max()))
        print(f"K3 talker_step B={B} S={S} pos={p}: max_abs_err {err:.3e} "
              f"against its plain version (h and rows)")
        check(err == 0, f"K3 disagrees with its plain version (B={B})")
        b_idx = torch.arange(B, device="cuda")
        mask = torch.ones((B, S), dtype=torch.bool, device="cuda")
        mask[b_idx, pos] = False
        check(torch.equal(kv_k[:, :, mask], kv[:, :, mask]),
              "K3 changed KV rows other than pos")
        check(torch.equal(kv_k[:, :, b_idx, pos],
                          rows_got.to(kv.dtype)),
              "K3 did not scatter the fresh rows at pos")
        worst = max(worst, err)
        if B == 1:
            t_p = time_ms(lambda: talker_step_plain(layers, x, pos, kv, cos,
                                                    sin, eps), 1, 2)
    rows = bench_talker_step.time_cases(cfg, layers, K3_TIMED)
    for r in rows:
        print(f"  time {r['case']}: kernel {r['ms']:.4f} ms device (CUDA "
              f"graph replay; {r['gb_s']:.0f} GB/s of weights + K/V), "
              f"{r['eager_ms']:.4f} ms per eager call; bound "
              f"{r['bound_ms']:.4f} ms [{card}]")
    print(f"  plain version B=1: {t_p:.4f} ms per eager call [{card}]")
    # bound of the timed call (B=1, pos 490): weights, the K/V rows it
    # reads, x and the norms once, h and the fresh rows written; against
    # the products' 2 operations a weight at the bf16 tensor-core peak
    n_w = sum(layers[n].q.numel() for n in bench_talker_step.PRODUCTS)
    b_ms, b_by = least_time(
        bench_talker_step.bound_bytes(layers, cfg, [490]), 2.0 * n_w, 989e12)
    return {"name": "talker_step", "route": "cuda",
            "source": "qwen3_tts_tpu_torch/csrc/talker_step.cu",
            "replaces": "qwen3_tts_tpu/ops/pallas/talker_step.py:266",
            "max_abs_err": worst, "ms": rows[0]["ms"], "plain_ms": t_p,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "ms_b4": rows[1]["ms"], "ms_b8": rows[2]["ms"],
            "shape": f"B=1 S={S} L={cfg.num_layers} pos 490"}


def phase_cp_decode(eng, card: str) -> dict:
    """K2 on the engine's int8 code predictor against its plain version,
    B = 1, 4 and 8: greedy, every token and the last step's logits and
    residual row bit for bit; sampled (T 0.1, top-k 50), >= 99% of the
    draws equal. Its product alone (qsplit) against qmm at every width of a
    step, bit for bit. Then tools/bench_cp_decode: the time at B = 1, 4, 8
    (CUDA-graph replay and eager) and the weight rate (its profile comes
    in phase_kernel_profiles)."""
    import torch
    from qwen3_tts_tpu_torch.models import transformer as tfm
    from qwen3_tts_tpu_torch.ops.kernels.common import qmm
    from qwen3_tts_tpu_torch.ops.kernels.cp_decode import (cp_decode_cuda,
                                                           cp_decode_plain,
                                                           qsplit)
    from qwen3_tts_tpu_torch.tools import bench_cp_decode
    cfg = eng.cfg.code_predictor
    cpp = eng._cpp
    S = cfg.max_seq_len
    cos, sin = tfm.rope_cos_sin(torch.arange(S, device="cuda"),
                                cfg.head_dim, cfg.rope_theta)
    worst = 0.0
    for B in (1, 4, 8):
        kv, tok0, seeds = bench_cp_decode.inputs(cfg, B, seed=5 + B)
        kw = dict(eps=cfg.rms_norm_eps, top_k=50)
        ref, ref_lg, ref_x = cp_decode_plain(cpp, tok0, kv, cos, sin, seeds,
                                             temperature=0.0, greedy=True,
                                             scratch=True, **kw)
        got, got_lg, got_x = cp_decode_cuda(cpp, tok0, kv, cos, sin, seeds,
                                            temperature=0.0, greedy=True,
                                            scratch=True, **kw)
        torch.cuda.synchronize()
        n_bad = int((got != ref).sum())
        lg_err = float((got_lg - ref_lg).abs().max())
        x_err = float((got_x.float() - ref_x.float()).abs().max())
        same = torch.equal(got_lg, ref_lg) and torch.equal(got_x, ref_x)
        print(f"K2 cp_decode B={B} greedy: {n_bad} of {got.numel()} tokens "
              f"differ; last step's logits max_abs_err {lg_err:.3e}, "
              f"residual row {x_err:.3e}; bit-equal: {same}")
        check(n_bad == 0, f"K2 greedy tokens differ from the plain version "
                          f"(B={B}):\n{got.tolist()}\n{ref.tolist()}")
        check(same, f"K2 logits or residual row differ (B={B})")
        worst = max(worst, lg_err, x_err)
        agree, total = 0, 0
        for trial in range(4):
            sd = seeds + trial * 7919
            ref = cp_decode_plain(cpp, tok0, kv, cos, sin, sd,
                                  temperature=0.1, greedy=False, **kw)
            got = cp_decode_cuda(cpp, tok0, kv, cos, sin, sd,
                                 temperature=0.1, greedy=False, **kw)
            agree += int((got == ref).sum())
            total += got.numel()
        print(f"K2 cp_decode B={B} sampled (T=0.1, top-k 50): "
              f"{total - agree} of {total} draws differ")
        check(agree >= 0.99 * total, "K2 sampled draws disagree (< 99%)")
    # the product alone at each width of a step, clusters sized as there:
    # mtp, k, v (1024, 1024) and o (2048, 1024), down (3072, 1024) in
    # clusters of 8; q, head (1024, 2048) and gate, up (1024, 3072) of 4;
    # q|k|v (1024, 4096) and gate|up (1024, 6144) of 2
    g = torch.Generator(device="cuda").manual_seed(9)
    n_case = 0
    widths = ((1024, 1024), (1024, 2048), (2048, 1024), (1024, 3072),
              (3072, 1024), (1024, 4096), (1024, 6144))
    for K, N in widths:
        w = torch.randint(-127, 128, (K, N), generator=g, device="cuda",
                          dtype=torch.int8)
        sc = torch.rand((N,), generator=g, device="cuda") * 0.01 + 1e-3
        for R in (1, 4, 8):
            x = torch.randn((R, K), generator=g, device="cuda").bfloat16()
            check(torch.equal(qsplit(x, w, sc), qmm(x, w, sc)),
                  f"qsplit ({R},{K})x({K},{N}) != qmm")
            n_case += 1
    print(f"K2 product (qsplit) against qmm: {n_case} cases "
          f"({len(widths)} widths, R 1/4/8, clusters of 2, 4 and 8), all "
          f"bit-equal")

    lay = cpp["layers"]
    steps = cfg.num_groups - 1
    kv, tok0, seeds = bench_cp_decode.inputs(cfg, 1, seed=6)
    t_p = time_ms(lambda: cp_decode_plain(
        cpp, tok0, kv, cos, sin, seeds, eps=cfg.rms_norm_eps, top_k=50,
        temperature=0.1, greedy=False), 2, 3)
    rows = bench_cp_decode.time_cases(*bench_cp_decode.cp_params())
    for r in rows:
        print(f"  time B={r['B']} ({steps} steps): kernel {r['ms']:.4f} ms "
              f"device (CUDA graph replay; {r['weight_gb_s']:.0f} GB/s of "
              f"weights; streaming bound {r['bound_streaming_ms']:.4f} ms), "
              f"{r['eager_ms']:.4f} ms per eager call [{card}]")
    print(f"  plain version B=1: {t_p:.4f} ms per eager call [{card}]")
    # bound (B=1): every input once -- the int8 stack and its scales, the
    # 14 lm_heads used, the mtp projection, the norms, the prefill K/V
    # rows, one embedding row per step -- and the tokens written. (Each
    # step streams the stack again in the kernel, 14 x the step's bytes:
    # the stack exceeds the L2.)
    heads = cpp["lm_heads"]
    once = (sum(lay[n].q.numel() + 4 * lay[n].scale.numel()
                for n in bench_cp_decode.PROJ)
            + steps * (heads.q[1].numel() + 4 * heads.scale[1].numel())
            + nbytes(cpp["mtp_proj_w"], cpp["mtp_proj_b"],
                     cpp["final_norm"], *[lay[n] for n in (
                         "input_ln", "post_ln", "q_norm", "k_norm")])
            + cfg.num_layers * 2 * 2 * cfg.num_kv_heads * cfg.head_dim * 2
            + steps * cfg.hidden_size * 2 + steps * 4)
    b_ms, b_by = least_time(once)
    print(f"  bound B=1: {b_ms:.4f} ms ({b_by}; inputs once); streaming the "
          f"stack per step: {rows[0]['bound_streaming_ms']:.4f} ms [{card}]")
    return {"name": "cp_decode", "route": "cuda",
            "source": "qwen3_tts_tpu_torch/csrc/cp_decode.cu",
            "replaces": "qwen3_tts_tpu/ops/pallas/cp_decode.py:365",
            "max_abs_err": worst, "ms": rows[0]["ms"], "plain_ms": t_p,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "ms_b4": rows[1]["ms"], "ms_b8": rows[2]["ms"],
            "shape": "B=1, 14 steps, 5 layers"}


def phase_kernel_profiles(eng, card: str, k3: dict, k2: dict) -> None:
    """After every kernel is timed (a torch.profiler session slows later
    chains of dependent launches in the process by a few percent): K3 and
    K2 at their timed cases under the profiler, launches a call and device
    ms by kernel. Every K3 product must be one qsplit launch and its
    attention one launch a layer; K2 at most 28 launches a step."""
    from qwen3_tts_tpu_torch.tools import bench_cp_decode, bench_talker_step
    cfg = eng.cfg.talker
    L = cfg.num_layers
    rows = [{"case": c, "pos": p} for c, p in K3_TIMED]
    bench_talker_step.profile_cases(cfg, eng._tp["layers"], rows)
    for r in rows:
        print(f"K3 profile {r['case']}: {r['launches_per_call']:.0f} "
              f"launches a call [{card}]")
        for k, v in r["kernels"].items():
            print(f"    {k}: {v['launches']:g} launches, {v['ms']:.4f} ms a "
                  f"call")
        # a profile may miss events (never invent them): upper bounds,
        # and no kernel but the products, the attention and the converts
        kinds = {k.split("<")[0] for k in r["kernels"]}
        n = {k: sum(v["launches"] for kk, v in r["kernels"].items()
                    if kk.startswith(k)) for k in kinds}
        check({"qsplit_kernel", "talker_attn_kernel"} <= kinds
              <= {"qsplit_kernel", "talker_attn_kernel", "convert_kernel"}
              and r["launches_per_call"] <= 5 * L + 2
              and n["qsplit_kernel"] <= 4 * L
              and n["talker_attn_kernel"] <= L,
              f"K3 launches: {r['kernels']}")
    k3["launches_per_call"] = rows[0]["launches_per_call"]
    cp_cfg, cp = bench_cp_decode.cp_params()
    rows = [{"B": B} for B in bench_cp_decode.BATCHES]
    bench_cp_decode.profile_cases(cp_cfg, cp, rows)
    for r in rows:
        print(f"K2 profile B={r['B']}: {r['launches_per_call']:.0f} "
              f"launches a call ({r['launches_per_step']:.2f} a step) "
              f"[{card}]")
        for k, v in r["kernels"].items():
            print(f"    {k}: {v['launches']:g} launches, {v['ms']:.4f} ms a "
                  f"call")
    check(all(r["launches_per_step"] <= 28.5 for r in rows),
          "K2 launches more than 28 kernels a step")
    k2["launches_per_step"] = rows[0]["launches_per_step"]


# K1 launches a decode step of the slice (a token; the loop runs in
# chunks of 8 steps, so a request's steps round its tokens up to 8):
# codec_head, lm_heads[0] and the code predictor's 2-token prefill (5
# layers x q|k|v, o, gate|up, down), all on qsplit: 22; the talker
# prefill adds 4 a layer a request (qmm tile)
K1_PER_STEP = 23


def phase_slice(eng, card: str, counters: dict) -> dict:
    import numpy as np
    import torch
    for fn in counters.values():
        fn.launches = 0
    tokens = 0
    for i, text in enumerate(TEXTS):
        before = {k: fn.launches for k, fn in counters.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.synthesize(text, seed=i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = res.n_tokens
        grew = {k: fn.launches - before[k] for k, fn in counters.items()}
        print(f"request {i}: {text!r} n_tokens={n} samples="
              f"{len(res.audio_int16)} wall={wall:.3f}s "
              f"ms/token={1000 * wall / max(n, 1):.2f} RTF={res.rtf:.4f} "
              f"stages={ {k: round(v, 4) for k, v in res.timings.items()} } "
              f"launches={grew} [{card}]")
        check(n >= 1, "no tokens generated")
        check(res.codes.shape == (n, 16), f"codes shape {res.codes.shape}")
        check(bool(((res.codes >= 0) & (res.codes < 2048)).all()),
              "codes out of [0, 2048)")
        check(len(res.audio_int16) == n * 1920, "duration math broken")
        check(bool(np.isfinite(res.audio_int16.astype(np.float64)).all()),
              "non-finite audio")
        for k in ("qmatmul", "qmatmul_qsplit", "qmatmul_qmm", "talker_step",
                  "cp_decode"):
            check(grew[k] > 0, f"kernel {k} was not launched by request {i}")
        tokens += n
    k1 = counters["qmatmul"].launches
    steps = counters["talker_step"].launches   # one K3 launch a step
    cap = K1_PER_STEP * steps + 4 * eng.cfg.talker.num_layers * len(TEXTS)
    print(f"slice: K1 {k1} launches for {steps} decode steps ({tokens} "
          f"tokens kept; {k1 / steps:.2f} a step; qsplit "
          f"{counters['qmatmul_qsplit'].launches}, qmm tile "
          f"{counters['qmatmul_qmm'].launches}); at most {cap} "
          f"({K1_PER_STEP} a step and 4 a talker layer a request)")
    check(k1 <= cap, f"K1 launched {k1} times in the slice (cap {cap})")
    return {k: fn.launches for k, fn in counters.items()}


def phase_profile(eng, card: str) -> None:
    """One more request under torch.profiler: device busy time (the union
    of the kernels' intervals), device time by kernel (the launch counts
    of the checked requests are read before it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from qwen3_tts_tpu_torch.tools import bench_e2e
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = eng.synthesize(TEXTS[1], seed=1)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ka = prof.key_averages()
    busy, launches = bench_e2e.device_busy_ms(prof), bench_e2e.launches(prof)
    summed = bench_e2e.device_sum_ms(prof)
    n = max(res.n_tokens, 1)
    print(f"profile: {res.n_tokens} tokens, wall {wall:.3f} s under the "
          f"profiler, device busy {busy:.1f} ms ({busy / n:.2f} ms/token; "
          f"sum of kernel times {summed:.1f} ms), {launches} kernel "
          f"launches ({launches / n:.0f}/token) [{card}]")
    print(ka.table(sort_by="self_device_time_total", row_limit=15,
                   max_name_column_width=50))

def _attn_inputs(g, B, S, dtype, Hq=16, Hkv=8, Dh=128):
    import torch
    q = torch.randn((B, Hq, Dh), generator=g, device="cuda").to(dtype)
    k = torch.randn((B, S, Hkv, Dh), generator=g, device="cuda").to(dtype)
    v = torch.randn((B, S, Hkv, Dh), generator=g, device="cuda").to(dtype)
    return q, k, v


def _rel_err(got, ref) -> tuple:
    err = float((got.float() - ref.float()).abs().max())
    return err, float(ref.float().abs().max())


def phase_decode_attention(card: str) -> dict:
    """K5 at the talker's geometry (Hq 16, Hkv 8, Dh 128, S 512) and the
    code predictor's cache length (S 16) against its plain version, f32
    and bf16, B = 1, 4 and 8, positions 0, S-1 and on split boundaries
    (error 0 expected: the plain version adds up in the kernel's order);
    rows past pos poisoned change no bit. Then its time at the four
    shapes of tools/bench_decode_attention (bf16, K/V from HBM: the
    caches cycled read at least 3x the L2; CUDA-graph replay), each beside
    its bound and scaled_dot_product_attention's time on the same
    inputs."""
    import torch
    from qwen3_tts_tpu_torch.ops.kernels.decode_attention import (
        NSPLIT, decode_attention_cuda, decode_attention_plain)
    from qwen3_tts_tpu_torch.tools import bench_decode_attention
    g = torch.Generator(device="cuda").manual_seed(7)
    Hq, Hkv, Dh, worst = 16, 8, 128, 0.0
    for S in (512, 16):
        C = -(-S // NSPLIT)
        for dtype in (torch.float32, torch.bfloat16):
            for B in (1, 4, 8):
                q, k, v = _attn_inputs(g, B, S, dtype)
                pos = torch.tensor([S - 1] if B == 1 else
                                   [0, S - 1, C - 1, C, 3 * C, 2 * C - 1,
                                    S // 3, 1][:B], device="cuda")
                ref = decode_attention_plain(q, k, v, pos)
                got = decode_attention_cuda(q, k, v, pos)
                torch.cuda.synchronize()
                err, _ = _rel_err(got, ref)
                print(f"K5 decode_attention {str(dtype)[6:]} S={S} B={B} pos="
                      f"{pos.tolist()}: max_abs_err {err:.3e}")
                check(got.dtype == dtype and err == 0,
                      f"K5 disagrees with its plain version ({dtype}, S={S},"
                      f" B={B})")
                worst = max(worst, err)
            a = decode_attention_cuda(q, k, v, pos)
            for b, p in enumerate(pos.tolist()):
                k[b, p + 1:] = 99.0
                v[b, p + 1:] = -99.0
            same = torch.equal(decode_attention_cuda(q, k, v, pos), a)
            print(f"K5 S={S} {str(dtype)[6:]} B={B}: rows past pos poisoned "
                  f"(+-99), output unchanged: {same}")
            check(same, "K5 reads rows past pos")
    shapes = bench_decode_attention.run()
    for r in shapes:
        print(f"  time {r['shape']} bf16 S=512: kernel {r['ms']:.5f} ms "
              f"device (CUDA graph replay over {r['caches']} caches, "
              f"{r['mb_read_a_cycle']:.0f} MB of K/V a cycle); bound "
              f"{r['bound_ms']:.5f} ms ({r['bound_by']}, "
              f"{r['bound_ms'] / r['ms']:.1%} of it); SDPA (GQA, bool mask) "
              f"{r['library_ms']:.5f} ms, max_abs_err vs K5 "
              f"{r['sdpa_max_abs_err']:.3e}; K5 / SDPA "
              f"{r['ms'] / r['library_ms']:.3f} [{card}]")
    q, k, v = _attn_inputs(g, 4, 512, torch.bfloat16)
    pos = torch.tensor(bench_decode_attention.SHAPES[0][2], device="cuda")
    t_p = time_ms(lambda: decode_attention_plain(q, k, v, pos), 2, 3)
    print(f"  plain {shapes[0]['shape']}: {t_p:.3f} ms")
    main = shapes[0]
    return {"name": "decode_attention", "route": "cuda",
            "source": "qwen3_tts_tpu_torch/csrc/decode_attention.cu",
            "replaces": "qwen3_tts_tpu/ops/pallas/decode_attention.py:85",
            "max_abs_err": worst, "ms": main["ms"], "plain_ms": t_p,
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "shape": f"{main['shape']} Hq=16 Hkv=8 Dh=128 S=512 bf16",
            "shapes": shapes}


def _no_copy_ops(fn) -> list:
    """The aten ops fn dispatches that copy or convert a tensor (each
    would be a kernel launch beside the hand-written one)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.append(str(func))
            return func(*args, **(kwargs or {}))
    with Ops() as mode:
        fn()
    return [o for o in mode.seen if "copy" in o or "to_" in o]


def phase_paged_attention(card: str) -> dict:
    """K4 at the paged batcher's page geometry (pages of 64, 9 a row, a
    scrambled table, row 0 one page and the rest of its table the
    reserved page 0) at B = 4 and 8, f32 and bf16, against its plain
    version and against K5 over the rows the table gathers, error 0
    (K4 is K5's split behind the table); its dispatcher on the batcher's
    operands (bf16, int32 table and pos) dispatches no copy or convert.
    Then its time at B = 4 and 8, bf16 (pools cycled past the L2, CUDA
    graph replay), beside its bound and, for reference only, SDPA over
    the gathered rows (tools/bench_decode_attention.run_paged)."""
    import torch
    from qwen3_tts_tpu_torch.ops.kernels.decode_attention import (
        decode_attention_cuda)
    from qwen3_tts_tpu_torch.ops.kernels.paged_attention import (
        paged_attention_cuda, paged_attention_plain, paged_decode_attention,
        paged_gather_kv)
    from qwen3_tts_tpu_torch.tools import bench_decode_attention
    g = torch.Generator(device="cuda").manual_seed(9)
    psz, MAXP = bench_decode_attention.PSZ, bench_decode_attention.MAXP
    Hq, Hkv, Dh = 16, 8, 128
    POS = {B: pl for _, B, pl in bench_decode_attention.PAGED_SHAPES}
    worst, timed = 0.0, {}
    for B, pl in POS.items():
        P = B * MAXP + 1
        perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(B))
        table = (perm[:B * MAXP] + 1).reshape(B, MAXP).to(torch.int32).cuda()
        table[0, 1:] = 0                   # row 0 holds one page
        pos = torch.tensor(pl, dtype=torch.int32, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((B, Hq, Dh), generator=g, device="cuda").to(dtype)
            pool = torch.randn((2, P, psz, Hkv, Dh), generator=g,
                               device="cuda").to(dtype)
            ref = paged_attention_plain(q, pool[0], pool[1], table, pos)
            got = paged_attention_cuda(q, pool[0], pool[1], table, pos)
            kv = paged_gather_kv(pool, table)
            dense = decode_attention_cuda(q, kv[0].contiguous(),
                                          kv[1].contiguous(), pos)
            torch.cuda.synchronize()
            err, _ = _rel_err(got, ref)
            err5, _ = _rel_err(got, dense)
            print(f"K4 paged_attention {str(dtype)[6:]} B={B} P={P} pos={pl}: "
                  f"max_abs_err {err:.3e} vs plain, {err5:.3e} vs K5 over "
                  f"the gathered rows")
            check(got.dtype == dtype and err == 0 and err5 == 0,
                  f"K4 disagrees with its plain version or K5 ({dtype}, "
                  f"B={B})")
            worst = max(worst, err, err5)
        copies = _no_copy_ops(lambda: paged_decode_attention(q, pool, table,
                                                             pos))
        print(f"K4 dispatcher on bf16 q and pool, int32 table and pos: copy "
              f"or convert ops {copies}")
        check(not copies, f"K4's dispatcher copies: {copies}")
        timed[B] = (q, pool, table, pos)
    shapes = bench_decode_attention.run_paged()
    for r in shapes:
        print(f"  time {r['shape']} bf16: kernel {r['ms']:.5f} ms device "
              f"(CUDA graph replay over {r['pools']} pools, "
              f"{r['mb_read_a_cycle']:.0f} MB of K/V a cycle); bound "
              f"{r['bound_ms']:.5f} ms ({r['bound_by']}, "
              f"{r['bound_ms'] / r['ms']:.1%} of it); reference only, not a "
              f"library call for this function: SDPA over the gathered rows "
              f"{r['sdpa_gathered_reference_ms']:.5f} ms [{card}]")
    q, pool, table, pos = timed[4]
    t_p = time_ms(lambda: paged_attention_plain(q, pool[0], pool[1], table,
                                                pos), 1, 2)
    print(f"  plain B=4: {t_p:.3f} ms per eager call [{card}]")
    b4, b8 = shapes
    return {"name": "paged_attention", "route": "cuda",
            "source": "qwen3_tts_tpu_torch/csrc/decode_attention.cu",
            "replaces": "qwen3_tts_tpu/ops/pallas/paged_attention.py:147",
            "max_abs_err": worst, "ms": b4["ms"], "plain_ms": t_p,
            "bound_ms": b4["bound_ms"], "bound_by": b4["bound_by"],
            "library_ms": None,
            "sdpa_gathered_reference_ms": b4["sdpa_gathered_reference_ms"],
            "ms_b8": b8["ms"], "bound_ms_b8": b8["bound_ms"],
            "shape": f"B=4 psz={psz} MAXP={MAXP} P=37 bf16", "shapes": shapes}


def phase_talker_merged(eng, card: str) -> list:
    """K7 at full geometry on the engine's int8 talker, premerged, at
    K3's check positions (B = 1, 4 and 8, chunk edges): both variants
    against their plain version (error 0) and against K3's kernel on the
    same inputs, bit for bit; the time of each at B = 1, pos 490 (and
    K3's, in the same call) by CUDA-graph replay beside its bound."""
    import torch
    from qwen3_tts_tpu_torch.models import transformer as tfm
    from qwen3_tts_tpu_torch.ops.kernels import talker_merged as tm
    from qwen3_tts_tpu_torch.ops.kernels.talker_step import talker_step_cuda
    cfg = eng.cfg.talker
    layers = tm.with_merged(eng._tp["layers"])
    S, eps = cfg.max_seq_len, cfg.rms_norm_eps
    cos, sin = tfm.rope_cos_sin(torch.arange(S, device="cuda"),
                                cfg.head_dim, cfg.rope_theta)
    g = torch.Generator(device="cuda").manual_seed(13)
    names = {False: "talker_step_merged", True: "talker_step_mergedvec"}
    worst = {False: 0.0, True: 0.0}
    for B, p in K3_POS.items():
        x = (torch.randn((B, cfg.hidden_size), generator=g, device="cuda")
             * 0.1).bfloat16()
        kv = (torch.randn((cfg.num_layers, 2, B, S, cfg.num_kv_heads,
                           cfg.head_dim), generator=g, device="cuda")
              * 0.5).bfloat16()
        pos = torch.tensor(p, dtype=torch.int32, device="cuda")
        h3, r3 = talker_step_cuda(layers, x, pos, kv, cos, sin, eps)
        for vec in (False, True):
            hk, rk = tm.talker_merged_cuda(layers, x, pos, kv, cos, sin, eps,
                                           vec)
            hp, rp = tm.talker_merged_plain(layers, x, pos, kv, cos, sin,
                                            eps, vec)
            torch.cuda.synchronize()
            err = max(float((hk.float() - hp.float()).abs().max()),
                      float((rk - rp).abs().max()))
            same = torch.equal(hk, h3) and torch.equal(rk, r3)
            print(f"K7 {names[vec]} B={B} pos={pos.tolist()}: max_abs_err "
                  f"{err:.3e} against its plain version (h and rows); "
                  f"bit-equal to K3: {same}")
            check(err == 0, f"K7 {names[vec]} disagrees with its plain "
                            f"version (B={B})")
            check(same, f"K7 {names[vec]} differs from K3 (B={B})")
            worst[vec] = max(worst[vec], err)
    # timing at B = 1, pos 490 (row 6 of the last x, kv of B = 8)
    x1, kv1 = x[6:7].contiguous(), kv[:, :, 6:7].contiguous()
    p1 = pos[6:7]
    check(int(p1) == 490, "K7 timing row is not at pos 490")
    t3 = time_ms(lambda: talker_step_cuda(layers, x1, p1, kv1, cos, sin,
                                          eps), 20, graph=True)
    kvbytes = cfg.num_layers * 2 * 491 * cfg.num_kv_heads * cfg.head_dim * 2
    rows_out = cfg.num_layers * 2 * cfg.num_kv_heads * cfg.head_dim * 4
    out = []
    for vec in (False, True):
        t_k = time_ms(lambda: tm.talker_merged_cuda(
            layers, x1, p1, kv1, cos, sin, eps, vec), 20, graph=True)
        t_p = time_ms(lambda: tm.talker_merged_plain(
            layers, x1, p1, kv1, cos, sin, eps, vec), 1, 2)
        # bound: every input the variant reads once (int8 blocks, their
        # scales and the norms, or the vec block), the K/V rows 0..pos, x;
        # h and the fresh rows written
        ins = (["m_wA", "m_wB", "m_vec"] if vec else
               ["m_wA", "m_wB", "m_sA", "m_sB", "input_ln", "post_ln",
                "q_norm", "k_norm"])
        b_ms, b_by = least_time(nbytes(*[layers[n] for n in ins]) + kvbytes
                                + 2 * cfg.hidden_size * 2 + rows_out)
        print(f"  time {names[vec]} B=1 pos 490: kernel {t_k:.4f} ms device "
              f"(CUDA graph replay), K3 {t3:.4f} ms in the same call, plain "
              f"{t_p:.4f} ms; bound {b_ms:.4f} ms ({b_by}) [{card}]")
        out.append({"name": names[vec], "route": "cuda",
                    "source": "qwen3_tts_tpu_torch/csrc/talker_step.cu",
                    "replaces": "tools/dev/microbench_talker_merged.py:307",
                    "max_abs_err": worst[vec], "ms": t_k, "plain_ms": t_p,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                    "k3_ms_same_call": t3,
                    "shape": f"B=1 S={S} L={cfg.num_layers} pos 490"})
    return out


def phase_kv_int8(card: str) -> dict:
    """K6 at the talker's geometry (Hq 16, Hkv 8, Dh 128, S 512) against
    its plain version, f32 and bf16 q, B = 1, 4 and 8, positions with 0
    and 511 (error 0 expected: the plain version adds up in the kernel's
    order); rows past pos poisoned change no bit; the time at B = 4 bf16
    beside the bound. No single PyTorch call reads an int8 cache with
    per-row scales: SDPA over the same rows dequantized to bf16 is
    printed as a reference only."""
    import torch
    import torch.nn.functional as F
    from qwen3_tts_tpu_torch.ops.kernels.kv_int8 import (
        decode_attention_kv_int8_cuda, decode_attention_kv_int8_plain,
        dequantize_kv_rows, quantize_kv_rows)
    g = torch.Generator(device="cuda").manual_seed(11)
    S, Hq, Hkv, Dh = 512, 16, 8, 128
    POS = [0, S - 1, 200, 37, 450, 1, 300, 64]

    def cache(B):
        kf = torch.randn((B, Hkv, S, Dh), generator=g, device="cuda") * 0.5
        vf = torch.randn((B, Hkv, S, Dh), generator=g, device="cuda") * 0.5
        return kf, vf

    def pos_of(B):
        return torch.tensor(POS[:B] if B > 1 else [S - 1], device="cuda")

    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for B in (1, 4, 8):
            q = torch.randn((B, Hq, Dh), generator=g, device="cuda").to(dtype)
            kf, vf = cache(B)
            args = (q, *quantize_kv_rows(kf), *quantize_kv_rows(vf), pos_of(B))
            ref = decode_attention_kv_int8_plain(*args)
            got = decode_attention_kv_int8_cuda(*args)
            torch.cuda.synchronize()
            err = float((got.float() - ref.float()).abs().max())
            print(f"K6 decode_attention_kv_int8 {str(dtype)[6:]} B={B} pos="
                  f"{args[-1].tolist()}: max_abs_err {err:.3e}")
            check(got.dtype == dtype and err == 0,
                  f"K6 disagrees with its plain version ({dtype}, B={B})")
            worst = max(worst, err)
    # poison: rows past pos at +-99 before quantizing change no bit
    B = 4
    q = torch.randn((B, Hq, Dh), generator=g, device="cuda").bfloat16()
    kf, vf = cache(B)
    pos = pos_of(B)
    a = decode_attention_kv_int8_cuda(q, *quantize_kv_rows(kf),
                                      *quantize_kv_rows(vf), pos)
    for b, p in enumerate(pos.tolist()):
        kf[b, :, p + 1:] = 99.0
        vf[b, :, p + 1:] = -99.0
    kq, ks = quantize_kv_rows(kf)
    vq, vs = quantize_kv_rows(vf)
    same = torch.equal(decode_attention_kv_int8_cuda(q, kq, ks, vq, vs, pos),
                       a)
    print(f"K6 rows past pos poisoned (+-99): output unchanged: {same}")
    check(same, "K6 reads rows past pos")
    # time at B = 4, bf16 q: 28 layers' caches (117 MB), so each call
    # streams its cache from HBM as in a decode step
    caches = [(kq, ks, vq, vs)] + [tuple(t.clone() for t in (kq, ks, vq, vs))
                                   for _ in range(27)]
    it = itertools.cycle(range(28)).__next__
    t_k = time_ms(lambda: decode_attention_kv_int8_cuda(q, *caches[it()],
                                                        pos), 56, graph=True)
    t_p = time_ms(lambda: decode_attention_kv_int8_plain(q, kq, ks, vq, vs,
                                                         pos), 2, 3)
    rows = int((pos + 1).sum())
    # the JAX CostEstimate's bytes (kv_int8.py:120-123) over the rows
    # 0..pos: int8 K and V plus their f32 scales; q read and the output
    # written at their own size
    b_ms, b_by = least_time(2 * rows * Hkv * (Dh + 4) + nbytes(q, pos)
                            + q.numel() * 2,
                            4.0 * rows * Hq * Dh + 2.0 * rows * Hkv * Dh)
    mask = (torch.arange(S, device="cuda")[None, :]
            <= pos[:, None])[:, None, None, :]
    deq = [(dequantize_kv_rows(c[0], c[1]).bfloat16(),
            dequantize_kv_rows(c[2], c[3]).bfloat16()) for c in caches]
    sdpa = time_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], *deq[it()], attn_mask=mask, enable_gqa=True), 56,
        graph=True)
    del deq, caches
    print(f"  time B=4 bf16 S={S}: kernel {t_k:.5f} ms device (CUDA graph "
          f"replay, int8 K/V from HBM), plain {t_p:.3f} ms; bound "
          f"{b_ms:.5f} ms ({b_by}: {rows} K/V rows); reference only, not a "
          f"library call for this function: SDPA over the same rows "
          f"dequantized to bf16 {sdpa} ms [{card}]")
    return {"name": "decode_attention_kv_int8", "route": "cuda",
            "source": "qwen3_tts_tpu_torch/csrc/kv_int8.cu",
            "replaces": "qwen3_tts_tpu/ops/pallas/kv_int8.py:115",
            "max_abs_err": worst, "ms": t_k, "plain_ms": t_p,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "sdpa_bf16_reference_ms": sdpa,
            "shape": f"B=4 Hq=16 Hkv=8 Dh=128 S={S} int8 KV, bf16 q"}


def _serve(b, card: str, label: str, counters: dict):
    """Serve BATCH_TEXTS through batcher b (step() driven), with the
    counters set to 0 before and read after. Returns (codes per request,
    launches)."""
    import numpy as np
    import torch
    from qwen3_tts_tpu_torch.tools import bench_e2e
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    futs = [b.submit(*bench_e2e.encode_text(t), seed=i)
            for i, t in enumerate(BATCH_TEXTS)]
    steps = 0
    while not all(f.done() for f in futs):
        check(steps < 400, f"{label}: requests not done after 400 steps")
        b.step()
        steps += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    codes, total_audio = [], 0
    for i, f in enumerate(futs):
        c, a = f.result(timeout=0)
        r = f.request
        n = len(c)
        check(n >= 1, f"{label}: request {i} gave no tokens")
        check(bool(((c >= 0) & (c < 2048)).all()),
              f"{label}: codes out of [0, 2048)")
        check(len(a) == n * 1920, f"{label}: duration math broken")
        check(bool(np.isfinite(a.astype(np.float64)).all()),
              f"{label}: non-finite audio")
        total_audio += len(a) / 24000
        codes.append(c)
        print(f"  {label} request {i}: n_tokens={n} wall "
              f"{r.t_done - r.t_submit:.3f} s (queued "
              f"{r.t_admit - r.t_submit:.3f} s, first token after "
              f"{r.t_first - r.t_admit:.3f} s) [{card}]")
    check(all(r is None for r in b._slot_req), f"{label}: a slot is busy")
    print(f"{label}: {len(futs)} requests, {b.batch_size} slots, {steps} "
          f"scheduler steps, wall {wall:.3f} s, {total_audio:.2f} s of "
          f"audio, {total_audio / wall:.3f} audio-s per wall-s, launches "
          f"{launches} [{card}]")
    return codes, launches


def profile_batcher_step(b, card: str, label: str) -> None:
    """One scheduler step (admission of 4 requests and a 16-token chunk)
    under torch.profiler: device busy time per loop step and the kernels
    that take it; the requests are then drained outside the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from qwen3_tts_tpu_torch.tools import bench_e2e
    futs = [b.submit(*bench_e2e.encode_text(t), seed=i)
            for i, t in enumerate(BATCH_TEXTS[:4])]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        b.step()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ka = prof.key_averages()
    busy, launches = bench_e2e.device_busy_ms(prof), bench_e2e.launches(prof)
    summed = bench_e2e.device_sum_ms(prof)
    steps = b.decode_chunk
    # K5 and K4 share one kernel body (decode_attn_split_kernel)
    att = [e for e in ka if "decode_attn" in e.key
           and str(e.device_type).endswith("CUDA")]
    att_ms = sum(e.self_device_time_total for e in att) / 1e3
    att_n = sum(e.count for e in att)
    check(att_n > 0, f"{label} profile: no attention kernel in the trace")
    print(f"{label} profile: attention (decode_attn_split_kernel) {att_n} "
          f"launches, {att_ms:.4f} ms device, {att_ms / steps:.4f} ms per "
          f"loop step ({att_ms / att_n * 1e3:.2f} us a launch) [{card}]")
    print(f"{label} profile: one scheduler step (4 admissions + "
          f"{steps} loop steps), wall {wall:.3f} s under the profiler, "
          f"device busy {busy:.1f} ms ({busy / steps:.2f} ms per loop "
          f"step; sum of kernel times {summed:.1f} ms), {launches} kernel "
          f"launches ({launches / steps:.0f} per loop step) [{card}]")
    print(ka.table(sort_by="self_device_time_total", row_limit=12,
                   max_name_column_width=50))
    while not all(f.done() for f in futs):
        b.step()


def phase_batcher(params, card: str, counters: dict) -> dict:
    """The continuous batcher at full geometry: dense with
    attention_impl="pallas" (K5), then paged (K4), each run twice."""
    import numpy as np
    import torch
    from qwen3_tts_tpu_torch.config import TalkerConfig, TTSConfig
    from qwen3_tts_tpu_torch.serve.batching import ContinuousBatcher
    cfg = TTSConfig(talker=TalkerConfig(attention_impl="pallas"))
    runs = {}
    for paged in (False, True):
        label = "paged batcher" if paged else "dense batcher"
        kw = dict(paged=True, page_size=64) if paged else {}
        t0 = time.perf_counter()
        b = ContinuousBatcher(cfg, params, batch_size=4, decode_chunk=16,
                              device="cuda", **kw)
        torch.cuda.synchronize()
        print(f"{label}: ready in {time.perf_counter() - t0:.1f} s "
              f"(bf16 talker, int8 code predictor)")
        codes, launches = _serve(b, card, label, counters)
        need = ("paged_attention" if paged else "decode_attention",
                "cp_decode", "qmatmul")
        for k in need:
            check(launches[k] > 0, f"{label}: {k} was not launched")
        if paged:
            check(len(b._free_pages) == b.pool_pages - 1,
                  "paged batcher: pages not all back in the free list")
            b._free.reverse()      # hand out other pages the second time
        codes2, _ = _serve(b, card, label + " (rerun)", counters)
        profile_batcher_step(b, card, label)
        same = all(np.array_equal(x, y) for x, y in zip(codes, codes2))
        print(f"{label}: rerun codes equal: {same}")
        check(same, f"{label}: a rerun gave other codes")
        if paged:
            check(len(b._free_pages) == b.pool_pages - 1,
                  "paged batcher: pages not all back after the rerun")
            dense = runs[False][0]
            eq = sum(int((x[:len(y)] == y[:len(x)]).all(-1).sum())
                     for x, y in zip(codes, dense))
            tot = sum(max(len(x), len(y)) for x, y in zip(codes, dense))
            print(f"paged vs dense: {eq} of {tot} code rows equal (K4 and "
                  f"K5 add up in other orders, so the streams may part)")
        runs[paged] = (codes, launches)
        del b
    return {"decode_attention": runs[False][1]["decode_attention"],
            "paged_attention": runs[True][1]["paged_attention"]}


def phase_synth_batch(card: str, counters: dict) -> None:
    """TTSEngine.synthesize_batch: 3 texts in one batched decode, bf16
    talker with attention_impl="pallas"."""
    import numpy as np
    import torch
    from qwen3_tts_tpu_torch.config import TalkerConfig, TTSConfig
    from qwen3_tts_tpu_torch.engine.engine import TTSEngine
    eng = TTSEngine(TTSConfig(talker=TalkerConfig(attention_impl="pallas")),
                    device="cuda", seed=1)
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.synthesize_batch(list(TEXTS), seed=3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    for i, r in enumerate(res):
        check(r.n_tokens >= 1 and r.codes.shape == (r.n_tokens, 16),
              "synthesize_batch: bad codes")
        check(len(r.audio_int16) == r.n_tokens * 1920,
              "synthesize_batch: duration math broken")
        check(bool(np.isfinite(r.audio_int16.astype(np.float64)).all()),
              "synthesize_batch: non-finite audio")
    check(launches["decode_attention"] > 0,
          "synthesize_batch: K5 was not launched")
    audio = sum(len(r.audio_int16) for r in res) / 24000
    print(f"synthesize_batch: n_tokens {[r.n_tokens for r in res]}, wall "
          f"{wall:.3f} s, {audio:.2f} s of audio, RTF {wall / audio:.4f}, "
          f"stages { {k: round(v, 4) for k, v in res[0].timings.items()} }, "
          f"launches {launches} [{card}]")


def phase_bench_kv_int8(card: str, counters: dict) -> dict:
    """The port of tools/dev/bench_kv_int8.py at TTSConfig() (28 layers,
    S 512): the bf16 loop (models/transformer.decode_step) against the
    int8-KV loop (K6) at B = 4 and 8, 16 steps, 3 interleaved trials."""
    import torch
    from qwen3_tts_tpu_torch.config import TTSConfig
    from qwen3_tts_tpu_torch.tools import bench_kv_int8
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = bench_kv_int8.run(TTSConfig(), batches=(4, 8), rep=16, trials=3,
                            device="cuda")
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    for B, row in res.items():
        print(f"bench_kv_int8 B={B}: hidden cosine min {row['cos_min']:.6f} "
              f"last {row['cos_last']:.6f}; bf16 {row['bf16_ms']:.3f} "
              f"ms/step, int8 KV {row['int8kv_ms']:.3f} ms/step (medians of "
              f"3; minima {row['bf16_min_ms']:.3f} / "
              f"{row['int8kv_min_ms']:.3f}) [{card}]")
        check(row["cos_min"] >= 0.99,
              f"bench_kv_int8 B={B}: hidden cosine {row['cos_min']} < 0.99")
    print(f"bench_kv_int8: {time.perf_counter() - t0:.1f} s, launches "
          f"{launches}")
    check(launches["decode_attention_kv_int8"] > 0,
          "bench_kv_int8: K6 was not launched")
    return {"decode_attention_kv_int8": launches["decode_attention_kv_int8"]}


def phase_microbench_merged(card: str, counters: dict) -> dict:
    """The port of tools/dev/microbench_talker_merged.py at TTSConfig():
    48 tokens through run_steps per variant, then 2 interleaved trials.
    The tool asserts equal codes; each variant's checked run must launch
    its own talker step kernel and no other."""
    import torch
    from qwen3_tts_tpu_torch.config import TTSConfig
    from qwen3_tts_tpu_torch.tools import microbench_talker_merged as mb
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = mb.run(TTSConfig(), n_tok=48, trials=2, device="cuda")
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    for name, per in res["launches"].items():
        print(f"microbench_talker_merged {name}: launches in its checked run "
              f"{per}")
        check(per[name] > 0, f"{name}: its step kernel never launched")
        check(all(n == 0 for k, n in per.items() if k != name),
              f"{name}: another variant's kernel launched: {per}")
    print(f"microbench_talker_merged: codes equal across the variants "
          f"(n_codes {res['n_codes']}); ms/token "
          f"{ {k: round(v, 3) for k, v in res['ms_per_tok'].items()} } "
          f"[{card}]; {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"metric": "talker_merged_streams_ms_per_tok",
                      **res["ms_per_tok"]}))
    check(res["n_codes"] >= 1, "microbench_talker_merged: no codes")
    return {k: launches[k] for k in ("talker_step_merged",
                                     "talker_step_mergedvec")}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "qwen3_tts_tpu_torch", "csrc")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    from qwen3_tts_tpu_torch.ops.kernels import _build
    t0 = time.perf_counter()
    _build.load()
    print(f"kernels built+loaded in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds} s) -> {_build.library_path()}")

    from qwen3_tts_tpu_torch.config import TTSConfig
    from qwen3_tts_tpu_torch.engine.engine import TTSEngine
    from qwen3_tts_tpu_torch.io.weights import init_random_params
    from qwen3_tts_tpu_torch.ops.kernels.cp_decode import cp_decode_steps
    from qwen3_tts_tpu_torch.ops.kernels.decode_attention import (
        decode_attention)
    from qwen3_tts_tpu_torch.ops.kernels.kv_int8 import (
        decode_attention_kv_int8)
    from qwen3_tts_tpu_torch.ops.kernels.paged_attention import (
        paged_decode_attention)
    from qwen3_tts_tpu_torch.ops.kernels.qmatmul import (
        qmatmul, qmatmul_qmm, qmatmul_qsplit)
    from qwen3_tts_tpu_torch.ops.kernels.talker_merged import (
        talker_decode_step_merged, talker_decode_step_mergedvec)
    from qwen3_tts_tpu_torch.ops.kernels.talker_step import (
        talker_decode_step_fused)

    t0 = time.perf_counter()
    eng = TTSEngine(TTSConfig(), quantize="int8", device="cuda", seed=0)
    torch.cuda.synchronize()
    print(f"engine (random int8 weights, full geometry) ready in "
          f"{time.perf_counter() - t0:.1f} s")

    kernels = [phase_qmatmul(card), phase_talker_step(eng, card),
               *phase_talker_merged(eng, card), phase_cp_decode(eng, card),
               phase_decode_attention(card), phase_paged_attention(card),
               phase_kv_int8(card)]
    by_name = {k["name"]: k for k in kernels}
    phase_kernel_profiles(eng, card, by_name["talker_step"],
                          by_name["cp_decode"])
    counters = {"qmatmul": qmatmul, "qmatmul_qsplit": qmatmul_qsplit,
                "qmatmul_qmm": qmatmul_qmm,
                "talker_step": talker_decode_step_fused,
                "cp_decode": cp_decode_steps,
                "decode_attention": decode_attention,
                "paged_attention": paged_decode_attention,
                "decode_attention_kv_int8": decode_attention_kv_int8,
                "talker_step_merged": talker_decode_step_merged,
                "talker_step_mergedvec": talker_decode_step_mergedvec}
    launches = phase_slice(eng, card, counters)
    for k in ("qmatmul", "talker_step", "cp_decode"):
        check(launches[k] > 0, f"{k} never launched in the slice")
    phase_profile(eng, card)
    del eng
    params = init_random_params(TTSConfig(), seed=0,
                                dtype=torch.bfloat16, device="cuda")
    launches.update(phase_batcher(params, card, counters))
    del params
    phase_synth_batch(card, counters)
    launches.update(phase_bench_kv_int8(card, counters))
    launches.update(phase_microbench_merged(card, counters))
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
