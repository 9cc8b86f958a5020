#!/usr/bin/env python3
"""Drive the PyTorch port (qwen3_tts_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

1. Set-up: the card (name, power limit), torch and CUDA versions; build
   the CUDA kernels from csrc/ (build seconds).
2. Kernels: each hand-written kernel against its plain PyTorch version on
   the card at the main path's shapes (full 0.6B geometry, random
   weights): K1 qmatmul, K3 talker_step, K2 cp_decode, with the stated
   tolerances and the median time of each beside its plain version's.
3. Slice: TTSEngine(TTSConfig(), quantize="int8") synthesizes three short
   texts; each request must give codes in range, n_tokens * 1920 finite
   samples, and launch every kernel.
4. Profile: one more request under torch.profiler, after the checked
   ones: device time by kernel, device busy time, launches per token.
5. One JSON line of per-kernel results, then the card line, then
   {"ok": true, "device": {...}} as the last line.

Exits non-zero (and prints no result) without a CUDA device, outside a
checkout of the repository, or when any check fails.
"""

from __future__ import annotations

import itertools
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

TEXTS = ("Привет, мир!", "Hello from the port.", "Добрый день.")


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, reps: int = 5, graph: bool = False) -> float:
    """Median over ``reps`` of the mean CUDA-event time of ``iters``
    back-to-back calls, after one warm-up call. ``graph=True`` captures
    the calls in a CUDA graph and times its replay: the device time of a
    call whose host side (Python, ctypes) takes longer than its kernels."""
    import torch
    fn()
    torch.cuda.synchronize()
    run = lambda: [fn() for _ in range(iters)]  # noqa: E731
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            run()
        run = g.replay
        run()
        torch.cuda.synchronize()
    vals = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        run()
        e.record()
        e.synchronize()
        vals.append(s.elapsed_time(e) / iters)
    return statistics.median(vals)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def close(got, ref, rtol: float, atol: float) -> bool:
    return bool(((got.float() - ref.float()).abs()
                 <= atol + rtol * ref.float().abs()).all())


def phase_qmatmul(card: str) -> dict:
    import torch
    from qwen3_tts_tpu_torch.ops.kernels.qmatmul import (qmatmul,
                                                         qmatmul_plain)
    g = torch.Generator(device="cuda").manual_seed(1)
    worst, times = 0.0, {}
    for M, K, N, what in ((1, 1024, 3072, "codec_head"),
                          (2, 1024, 2048, "cp prefill q_proj"),
                          (73, 1024, 4096, "talker prefill qkv")):
        x = torch.randn((M, K), generator=g, device="cuda").bfloat16()
        q = torch.randint(-127, 128, (K, N), generator=g, device="cuda",
                          dtype=torch.int8)
        s = torch.rand((N,), generator=g, device="cuda") * 0.01 + 1e-3
        ref = qmatmul_plain(x, q, s)
        got = qmatmul(x, q, s)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        bound = 2e-3 * float(ref.abs().max())
        print(f"K1 qmatmul ({M},{K})x({K},{N}) [{what}]: max_abs_err "
              f"{err:.3e} (bound {bound:.3e})")
        check(err <= bound, f"K1 ({M},{K},{N}) disagrees with its plain "
                            "version")
        worst = max(worst, err)
        # cycle through copies of the weight that together exceed the
        # 50 MB L2, so each call streams its weight from HBM as in decode
        qs = [q] + [q.clone() for _ in range((64 << 20) // (K * N))]
        nxt = itertools.cycle(qs).__next__
        t_k = time_ms(lambda: qmatmul(x, nxt(), s), 50, graph=True)
        t_p = time_ms(lambda: qmatmul_plain(x, nxt(), s), 50, graph=True)
        del qs
        times[(M, K, N)] = (t_k, t_p)
        gbs = K * N / (t_k * 1e-3) / 1e9
        print(f"  device time (CUDA graph replay, weights from HBM): kernel "
              f"{t_k:.4f} ms ({gbs:.0f} GB/s of int8 weights), plain "
              f"{t_p:.4f} ms [{card}]")
    t_k, t_p = times[(1, 1024, 3072)]
    return {"name": "qmatmul", "route": "cuda",
            "source": "qwen3_tts_tpu_torch/csrc/qmatmul.cu",
            "replaces": "qwen3_tts_tpu/ops/pallas/qmatmul.py:48",
            "max_abs_err": worst, "ms": t_k, "plain_ms": t_p,
            "shape": "(1,1024)x(1024,3072)"}


def phase_talker_step(eng, card: str) -> dict:
    import torch
    from qwen3_tts_tpu_torch.models import transformer as tfm
    from qwen3_tts_tpu_torch.ops.kernels.talker_step import (
        talker_decode_step_fused, talker_step_cuda, talker_step_plain)
    cfg = eng.cfg.talker
    layers = eng._tp["layers"]
    S = cfg.max_seq_len
    cos, sin = tfm.rope_cos_sin(torch.arange(S, device="cuda"),
                                cfg.head_dim, cfg.rope_theta)
    eps = cfg.rms_norm_eps
    g = torch.Generator(device="cuda").manual_seed(3)
    worst, t = 0.0, None
    for B in (1, 4):
        x = (torch.randn((B, cfg.hidden_size), generator=g, device="cuda")
             * 0.1).bfloat16()
        kv = (torch.randn((cfg.num_layers, 2, B, S, cfg.num_kv_heads,
                           cfg.head_dim), generator=g, device="cuda")
              * 0.5).bfloat16()
        pos = torch.randint(1, S - 1, (B,), generator=g, device="cuda")
        h_ref, rows_ref = talker_step_plain(layers, x, pos, kv, cos, sin, eps)
        kv_k = kv.clone()
        h_got, kv_k = talker_decode_step_fused(layers, x, pos, kv_k, cos, sin,
                                               eps=eps)
        _, rows_got = talker_step_cuda(layers, x, pos, kv, cos, sin, eps)
        torch.cuda.synchronize()
        err = float((h_got.float() - h_ref.float()).abs().max())
        rerr = float((rows_got - rows_ref).abs().max())
        print(f"K3 talker_step B={B} S={S} pos={pos.tolist()}: h max_abs_err "
              f"{err:.3e}, rows max_abs_err {rerr:.3e}")
        check(close(h_got, h_ref, 5e-2, 2e-2), f"K3 h disagrees (B={B})")
        check(close(rows_got, rows_ref, 2e-2, 2e-2),
              f"K3 fresh rows disagree (B={B})")
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
            def k3(p):
                return lambda: talker_step_cuda(layers, x, p, kv, cos, sin,
                                                eps)
            t = (time_ms(k3(pos), 20, graph=True),
                 time_ms(lambda: talker_step_plain(layers, x, pos, kv, cos,
                                                   sin, eps), 5, 3))
            t_call = time_ms(k3(pos), 20)
            p64 = torch.full_like(pos, 64)
            t64 = time_ms(k3(p64), 20, graph=True)
            # bytes a step must read: the int8 weights and scales, and the
            # bf16 K/V rows 0..pos of every layer
            wbytes = sum(layers[n].q.numel() + 4 * layers[n].scale.numel()
                         for n in ("qkv_proj", "o_proj", "gateup_proj",
                                   "down_proj"))
            kvbytes = (cfg.num_layers * 2 * (int(pos[0]) + 1)
                       * cfg.num_kv_heads * cfg.head_dim * 2)
            print(f"  time B=1: kernel {t[0]:.4f} ms device (CUDA graph "
                  f"replay; {(wbytes + kvbytes) / t[0] / 1e6:.0f} GB/s of "
                  f"weights + KV), {t_call:.4f} ms per eager call, plain "
                  f"{t[1]:.4f} ms; kernel at pos 64: {t64:.4f} ms device "
                  f"[{card}]")
    return {"name": "talker_step", "route": "cuda",
            "source": "qwen3_tts_tpu_torch/csrc/talker_step.cu",
            "replaces": "qwen3_tts_tpu/ops/pallas/talker_step.py:266",
            "max_abs_err": worst, "ms": t[0], "plain_ms": t[1],
            "shape": f"B=1 S={S} L={cfg.num_layers}"}


def phase_cp_decode(eng, card: str) -> dict:
    import torch
    from qwen3_tts_tpu_torch.models import transformer as tfm
    from qwen3_tts_tpu_torch.ops.kernels.cp_decode import (cp_decode_cuda,
                                                           cp_decode_plain)
    cfg = eng.cfg.code_predictor
    cpp = eng._cpp
    S = cfg.max_seq_len
    cos, sin = tfm.rope_cos_sin(torch.arange(S, device="cuda"),
                                cfg.head_dim, cfg.rope_theta)
    g = torch.Generator(device="cuda").manual_seed(5)
    worst, t = 0, None
    for B in (1, 4):
        kv = torch.zeros((cfg.num_layers, 2, B, S, cfg.num_kv_heads,
                          cfg.head_dim), device="cuda", dtype=torch.bfloat16)
        kv[:, :, :, :2] = (torch.randn(kv[:, :, :, :2].shape, generator=g,
                                       device="cuda") * 0.5).bfloat16()
        tok0 = torch.randint(0, cfg.group_vocab_size, (B,), generator=g,
                             device="cuda", dtype=torch.int32)
        seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (B,), generator=g,
                              device="cuda", dtype=torch.int32)
        kw = dict(eps=cfg.rms_norm_eps, top_k=50)
        ref = cp_decode_plain(cpp, tok0, kv, cos, sin, seeds,
                              temperature=0.0, greedy=True, **kw)
        got = cp_decode_cuda(cpp, tok0, kv, cos, sin, seeds,
                             temperature=0.0, greedy=True, **kw)
        torch.cuda.synchronize()
        n_bad = int((got != ref).sum())
        print(f"K2 cp_decode B={B} greedy: {n_bad} of {got.numel()} tokens "
              f"differ")
        check(n_bad == 0, f"K2 greedy tokens differ from the plain version "
                          f"(B={B}):\n{got.tolist()}\n{ref.tolist()}")
        worst = max(worst, int((got.long() - ref.long()).abs().max()))
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
        if B == 1:
            def k2():
                return cp_decode_cuda(cpp, tok0, kv, cos, sin, seeds,
                                      temperature=0.1, greedy=False, **kw)
            t = (time_ms(k2, 10, graph=True),
                 time_ms(lambda: cp_decode_plain(
                    cpp, tok0, kv, cos, sin, seeds, temperature=0.1,
                    greedy=False, **kw), 2, 3))
            t_call = time_ms(k2, 10)
            # bytes the 14 steps must read: per step the int8 layer stack,
            # one lm_head and the bf16 mtp projection
            lay = cpp["layers"]
            step_bytes = (sum(lay[n].q.numel() + 4 * lay[n].scale.numel()
                              for n in ("q_proj", "k_proj", "v_proj",
                                        "o_proj", "gate_proj", "up_proj",
                                        "down_proj"))
                          + cpp["lm_heads"][1].q.numel()
                          + 4 * cpp["lm_heads"][1].scale.numel()
                          + cpp["mtp_proj_w"].numel()
                          * cpp["mtp_proj_w"].element_size())
            steps = cfg.num_groups - 1
            gbs = steps * step_bytes / t[0] / 1e6
            print(f"  time B=1 ({steps} steps): kernel {t[0]:.4f} ms device "
                  f"(CUDA graph replay; {gbs:.0f} GB/s of weights), "
                  f"{t_call:.4f} ms per eager call, plain "
                  f"{t[1]:.4f} ms [{card}]")
    return {"name": "cp_decode", "route": "cuda",
            "source": "qwen3_tts_tpu_torch/csrc/cp_decode.cu",
            "replaces": "qwen3_tts_tpu/ops/pallas/cp_decode.py:365",
            "max_abs_err": worst, "ms": t[0], "plain_ms": t[1],
            "shape": "B=1, 14 steps, 5 layers"}


def phase_slice(eng, card: str, counters: dict) -> dict:
    import numpy as np
    import torch
    for fn in counters.values():
        fn.launches = 0
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
        for k, d in grew.items():
            check(d > 0, f"kernel {k} was not launched by request {i}")
    return {k: fn.launches for k, fn in counters.items()}


def phase_profile(eng, card: str) -> None:
    """One more request under torch.profiler: device time by kernel (the
    launch counts of the checked requests are read before it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = eng.synthesize(TEXTS[1], seed=1)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ka = prof.key_averages()
    # device-side events only (an aten op also carries its kernels' time)
    busy = sum(e.self_device_time_total for e in ka
               if str(e.device_type).endswith("CUDA")) / 1e3
    launches = sum(e.count for e in ka if e.key == "cudaLaunchKernel")
    n = max(res.n_tokens, 1)
    print(f"profile: {res.n_tokens} tokens, wall {wall:.3f} s under the "
          f"profiler, device busy {busy:.1f} ms ({busy / n:.2f} ms/token), "
          f"{launches} kernel launches ({launches / n:.0f}/token) [{card}]")
    print(ka.table(sort_by="self_device_time_total", row_limit=15,
                   max_name_column_width=50))


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
    from qwen3_tts_tpu_torch.ops.kernels.cp_decode import cp_decode_steps
    from qwen3_tts_tpu_torch.ops.kernels.qmatmul import qmatmul
    from qwen3_tts_tpu_torch.ops.kernels.talker_step import (
        talker_decode_step_fused)

    t0 = time.perf_counter()
    eng = TTSEngine(TTSConfig(), quantize="int8", device="cuda", seed=0)
    torch.cuda.synchronize()
    print(f"engine (random int8 weights, full geometry) ready in "
          f"{time.perf_counter() - t0:.1f} s")

    kernels = [phase_qmatmul(card), phase_talker_step(eng, card),
               phase_cp_decode(eng, card)]
    counters = {"qmatmul": qmatmul, "talker_step": talker_decode_step_fused,
                "cp_decode": cp_decode_steps}
    launches = phase_slice(eng, card, counters)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        check(k["launches"] > 0, f"{k['name']} never launched in the slice")
    phase_profile(eng, card)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
