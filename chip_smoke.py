#!/usr/bin/env python3
"""Drive the PyTorch port (qwen3_tts_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

1. Set-up: the card (name, power limit), torch and CUDA versions; build
   the CUDA kernels from csrc/ (build seconds).
2. Kernels: each hand-written kernel against its plain PyTorch version on
   the card at the main paths' shapes (full 0.6B geometry, random
   weights): K1 qmatmul (both routes: grouped qsplit for decode rows at
   error 0; the tensor-core tile for prefill rows within its normalised-
   error bound of 2^-16, equal bits on a second launch, beside
   torch._weight_int8pack_mm and, for reference, cuBLAS over the
   dequantized weight; then the int8 talker's prefill at full geometry on
   one slice prefix with K1 on the tile against the same with K1's plain
   version, cosine >= 0.99), K3 talker_step, K7 talker_step_merged (both
   variants, also against K3), K2 cp_decode, K5 decode_attention, K4
   paged_attention (also against K5 over the gathered rows, B = 4 and 8),
   K6 decode_attention_kv_int8 (the int8 mode of K5's body: S 512, 577
   and 8192, timed beside K5 at the same positions), with the stated
   tolerances; the time of
   each beside its plain version's, its bound (bytes or operations at the
   card's published peaks) and, where one PyTorch call computes the same
   function, that call's time (K5 at the four shapes of
   qwen3_tts_tpu_torch/tools/bench_decode_attention). K3
   and K7 at B = 1, 4 and 8 with positions on the attention's chunk
   edges, bit for bit, and K3's time at B = 1, 4, 8
   (qwen3_tts_tpu_torch/tools/bench_talker_step). K2 at B = 1, 4 and 8:
   greedy tokens, the last step's logits and residual row bit for bit,
   its product alone against qmm at every width of a step, and its time
   (qwen3_tts_tpu_torch/tools/bench_cp_decode). Then the port of
   tools/dev/bench_kv_int8.py (qwen3_tts_tpu_torch.tools.bench_kv_int8):
   the bf16 and the int8-KV talker decode loops (K6) at B = 4 and 8; the
   hidden cosine between them must stay >= 0.99. Once every kernel and
   that probe are timed, K3's and K2's launches and per-kernel breakdown
   under torch.profiler (a profiler session slows later chains of
   dependent launches in the process by a few percent).
3. Chunked prefill, then streaming, timed before any profile. First
   talker.prefill_chunked on the int8 engine's weights: a 265-row prefix
   one-shot and in 3 windows of 128 rows, the final hidden and one
   decode step (K3) after each at cosine >= 0.9999 against one-shot, K1
   on the tile 4 a talker layer a window at R = 128 (its products' device
   ms, each prefill's ms), the ValueError of a window grid past the
   cache. Then the same int8 engine renders the three texts in turns in
   three modes: non-streaming (the chained vocoder, launched on the
   device codes buffer before the fetch), window streaming (the default:
   prefix windows of the codes buffer) and incremental streaming
   (QWEN3_TTS_ENGINE_STREAM=incremental), each with on_chunk; then one
   long request of each past the head chunks (at most 192 tokens, which
   runs the last decode call and the windows or stream steps up to the
   EOS-pacing bound), then the first text with the chain off; each
   request must give the chained request's codes, its pieces its audio,
   and int16 audio within +-1 LSB of the chained request's (the window
   stream and the unchained request on < 0.01% of the samples: bit for
   bit on the CPU, but cuBLAS picks its GEMM kernel by the window's row
   count), and launch K1 (both routes), K2 and K3. Printed:
   first_audio_seconds per text and mode and their medians, the RTF of
   each mode, the count of pieces, the launches of each mode, the
   unchained request's wall and stages. Then the continuous batcher, dense
   (K5) then paged (K4), serves six requests of at most 48 tokens, two
   of them streaming: each streaming request's segments make up its
   audio, within +-1 LSB of the batcher's own non-streaming vocoding of
   its codes; the first-segment latency is printed. Then
   synthesize_exact over 300 seeded codes (left-context chunks of 64, 25
   tokens of context): synthesize_chunked_context with 300 tokens of
   context (sample-exact by construction) within +-1 LSB of the
   one-window decode, synthesize_exact's 25-token context within f32
   1e-4 of it (the JAX package's bound for that truncation); the same
   weights and codes through the port on the CPU agree with the card
   within +-1 LSB and give the same truncation gap within 10%.
   Then the engine's request surface (phase_engine_surface, also before
   any profile; every request of the earlier phases is cold, the prefix
   cache emptied before it): TTSEngine(quantize="int8-cp") on the three
   texts (K1 and K2 launched, K3 never; an engine given the code
   predictor already int8 reports "int8-cp" and gives equal codes); the
   int8 engine's prefix cache (A, B, A with equal codes and audio, a hit
   under another seed equal to that seed's cold request, a hit under
   max_tokens=5 stopping there, a streaming hit with the whole request's
   codes, no prefill tile on a hit; decode+vocoder and prefill stage ms
   cold and hit printed), its kv_cache_dir file (one written, restored with equal
   codes and audio); voice cloning from a prompt dir of 40 seeded frames
   (whole and streamed: equal codes, +-1 LSB; the cloned prefill on the
   tile 4 launches a talker layer at R = 137 rows, the second request a
   hit; the engine's cloned prefix equal bit for bit to the dense
   batcher's admission prefix; one cloned request among three plain ones
   through the dense (K5) and the paged (K4) batcher, each twice with
   equal codes); synthesize_long on a six-sentence paragraph (5 pieces,
   a group of 4 through synthesize_batch on K3; the result its pieces in
   order; with on_chunk equal codes, its chunks its audio, within +-1
   LSB; first-audio seconds and RTF printed). Then checkpoints
   (phase_checkpoint, before any profile, at full geometry in a temporary
   directory): the engine's seed-0 weights and a seeded encoder written
   as an HF checkpoint (model.safetensors in bf16, speech_tokenizer/ with
   decoder.* and encoder.* in f32; bytes and seconds printed);
   detect_tts_config equal to TTSConfig()'s; TTSEngine(model_dir,
   quantize="int8") gives the engine's codes and int16 audio bit for bit
   on the three texts, launching K1 (both routes), K2 and K3 (load
   seconds split into read, map and to-device; the tokenizer it got
   printed); convert_weights --quantize int8 to a params.npz, whose
   engine reports "int8" and gives the same codes; encode_reference_audio
   on 5 s of the port's vocoder output written at 16 kHz, on the card and
   with --device cpu: latents within 1e-4 of their scale, codes equal but
   for near ties (counted), the encoder's ms; the loaded engine's cloned
   request from that prompt dir (the tile at the cloned R) equal to the
   engine's; the CLI with --model_dir --quantize int8 writes a WAV.
   Then the serving tier (phase_serving, before any profile): the int8
   engine's daemon on the native accept loop (libttsrt must build) with
   a voice registry: the three texts as blobs, one chunked stream, one
   long request and one voice by name, each equal to the engine's own
   synthesis bit for bit (the stream to its streamed audio, within +-1
   LSB of the blob), the same daemon over HTTP (/v1/audio/speech equal
   to the blob, /metrics parsed); the bf16 batched daemon (4 slots,
   decode_chunk 32) dense (K5) then paged (K4), six concurrent clients
   of at most 48 tokens, two streaming, at pipeline_depth 1 and 2 in
   turns (1, 2, 2, 1 after a warm-up of each): every run's audio
   equal to the first depth-1 run's bit for bit; audio-s per wall-s,
   request wall p50 and first frame p50 and p95 per depth; the compat
   stack over the int8 weights through the reference client (codes in
   range, n_tokens x 1920 samples, K3, K2 and K1 launched); K1-K5
   launched in the phase.
   Then the kernels at a tp rank's shapes (phase_tp_kernels): K5 and K4
   on the talker's heads over tp = 2 and 4 (Hq 8 / Hkv 4, Hq 4 / Hkv 2)
   at the engine's and the batcher's rows and positions, K1 on every
   int8 weight of the code predictor's tp = 2 and 4 shards (q|k|v and
   gate|up grouped) at 1-8 rows, each at error 0 against its plain
   version. Then the dp x tp tier (phase_mesh, before any profile), every rank a
   subprocess of this script (--mesh-rank LEG DIR) under its own
   timeout, a failing rank failing the phase: leg a, one rank in an NCCL
   world of one: TTSEngine(mesh=make_mesh(1, 1), quantize="int8-cp") on
   the three texts and the dense (K5) and paged (K4) batchers on six
   requests (two streaming), 16 tokens each, equal to the same without a
   mesh bit for bit; leg b, dp 2 x tp 1, two ranks on the one card over
   gloo: both batchers, every served request's codes, audio and stream
   segments equal to the one-device batcher's bit for bit, the served
   sets a partition of the requests; leg c, dp 1 x tp 2 likewise, 4
   tokens a request: the int8-cp engine with K5 on the three texts
   (codes equal on both ranks; the talker hidden the first decode step
   reads and its codec logits at cosine >= 0.999 against the one-rank
   engine; the share of equal codes printed), one decode step from the
   one-rank engine's post-prefill state (the talker on the dense cache,
   K5, and in pages, K4, and the code predictor's prefill and first
   step, K1 on its shards) at cosine >= 0.999 against one rank on the
   same state for every hidden and logits, equal on both ranks, and
   the paged batcher (K4
   on 4 local kv heads) on three requests, codes equal on both ranks;
   K1, K4 and K5 launched, K2 and K3 not. Each leg's seconds, ms a token
   or loop step and launches are printed; two ranks on one card check
   correctness, not multi-GPU speed.
   Then the batched daemon over dp 2 x tp 1 (phase_daemon_mesh, before
   any profile): its two ranks (this script with --daemon-rank DIR, which
   runs serve/lockstep.rank_main, the rank entry of the daemon's own
   launcher) on the one card over gloo, rank 0 the front end that
   broadcasts every step's admissions, dense then paged (4 slots,
   decode_chunk 32, depth 2, a voice registry). Six concurrent clients
   (two streaming, at most 48 tokens), then a voice by name, a request
   capped at 5 tokens and a streaming client that leaves mid-decode, then
   one more request: every served request's n_tokens and audio equal to
   the one-rank batched daemon's (a one-rank mesh in this process, the
   same requests and seeds) bit for bit; the stream frames make the
   stream's audio; SIGTERM to rank 0 drains both ranks, which exit 0 and
   leave no socket; both ranks stepped alike, cancelled the vanished
   request, and hold no slot, no queued request and, paged, every page
   free at the stop. Printed: audio-s per wall-s and first-frame p50 of
   the six clients beside the one-rank daemon's, the phase's seconds and
   K1, K2 and K4 launches summed over the ranks. Then the serving soak
   (phase_soak, qwen3_tts_tpu_torch/tools/soak_daemon): 6 s of the mixed
   request surface (blob, streaming, cloned, capped, cancelled before
   admission and mid-decode; at most 64 tokens a request) through the
   bf16 batcher, dense then paged at depth 2; it must end healthy (every Future resolved, every slot and
   page free, no step failed, streams equal to their audio). Then the
   int8 quality dossier (phase_quality, qwen3_tts_tpu_torch/tools/
   quality_check): int8 and int8-cp against bf16 on the three texts, 32
   greedy steps, free-running and teacher-forced code agreement, hidden
   cosine and SNR, the tool's JSON line printed; int8 launches K3, K2 and
   K1, int8-cp K2 and K1 and no K3 and leaves the dense talker exact.
4. Slice: TTSEngine(TTSConfig(), quantize="int8") synthesizes three short
   texts; each request must give codes in range, n_tokens * 1920 finite
   samples, and launch K1 (on both routes), K2 and K3; K1 at most 23
   launches a decode step plus 4 a talker layer a request (the prefill),
   and the tile exactly 4 a talker layer a request.
5. Profile: one more request under torch.profiler, after the checked
   ones: device time by kernel, device busy time, launches per token.
6. Batcher: ContinuousBatcher (bf16 talker, int8 code predictor, 4 slots)
   serves 6 requests, dense with attention_impl="pallas" (K5), then paged
   (K4); each run twice, which must give equal codes (the paged rerun
   with its free pages handed out in reverse order), then one scheduler
   step of each under torch.profiler.
7. synthesize_batch: 3 texts in one batched decode (bf16, K5).
8. The port of tools/dev/microbench_talker_merged.py: run_steps with the
   talker step swapped for K3, K7 merged and K7 mergedvec; equal codes,
   each variant launching its own kernel and no other.
9. The command line: --long --quantize int8 --profile DIR writes a WAV
   and a torch.profiler trace.
10. One JSON line of per-kernel results (each kernel's launches on
   its main path, ``launches_mesh``: in phase_mesh, summed over its
   ranks, ``launches_daemon_mesh``: in phase_daemon_mesh, summed over its
   ranks, ``launches_soak``: in phase_soak, ``launches_chunked_prefill``:
   in phase_chunked_prefill's chunked prefill, ``launches_stream``: in
   phase_stream_engine by mode over the three texts; K1, K4 and K5 with
   ``max_abs_err_tp_shards``), then the card line, then
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
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

TEXTS = ("Привет, мир!", "Hello from the port.", "Добрый день.")
BATCH_TEXTS = ("Привет, мир!", "Hello from the port.", "Добрый день.",
               "How are you today?", "Спасибо.", "A short one.")
# a streaming request past the head chunks (8 + 56 tokens): with 75 text
# tokens the EOS boost starts at 0.8 * 3 * 75 = 180 tokens
LONG_TEXT = ("Hello from the port: this longer request streams well "
             "past its head chunks.")
LONG_TOKENS = 192
# a paragraph for synthesize_long: Russian and English, six sentences
PARAGRAPH = ("Привет! Как дела? Hello there, this is the port. It reads a "
             "whole paragraph. Сегодня хорошая погода. Good bye for now.")
# the voice-cloning prompt of phase_engine_surface: seeded codec frames
# and a short transcript, the format tools/encode_reference_audio.py writes
CLONE_FRAMES, CLONE_TEXT = 40, "Reference words."
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, published
F32_FLOPS = 67e12               # f32 outside the tensor cores, published
# int16 LSBs, and the share of samples, by which a window stream and an
# unchained request may differ from the chained request on the card: the
# incremental stream's contract. cuBLAS picks its f32 GEMM kernel by the
# row count, so the vocoder's first product already rounds differently
# at another window width (bit for bit on the CPU)
WINDOW_LSB, WINDOW_SHARE = 1, 1e-4


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


def phase_qmatmul(card: str) -> list:
    """K1 at the slice's shapes (tools/bench_qmatmul): each case on the
    route its shape picks, launched twice (equal bits); qsplit (decode
    rows, grouped) at error 0 against its plain version, the tile
    (prefill rows) within TILE_TOL of the product summed in float64, qmm's
    own error beside it. Then the time of each case (CUDA-graph replay,
    weights from HBM) beside its bound and, past 8 rows, the library's
    int8 product and cuBLAS over the dequantized weight; the plain
    version's time at codec_head and at the talker prefill's q|k|v, R =
    41. Returns the qsplit and the tile entries."""
    import torch
    from qwen3_tts_tpu_torch.ops.kernels import qmatmul as tqm
    from qwen3_tts_tpu_torch.tools import bench_qmatmul
    g = torch.Generator(device="cuda").manual_seed(1)
    worst = {"qsplit": 0.0, "tile": 0.0}
    worst_norm = plain_norm = 0.0
    for what, M, K, Ns in bench_qmatmul.CASES:
        x, ws = bench_qmatmul.inputs(g, M, K, Ns)
        route = "qsplit" if tqm.on_qsplit(M, K, Ns) else "tile"
        n0 = (tqm.qmatmul_qsplit.launches, tqm.qmatmul_tile.launches)
        got = tqm.qmatmul_group(x, ws)
        again = tqm.qmatmul_group(x, ws)
        n1 = (tqm.qmatmul_qsplit.launches - n0[0],
              tqm.qmatmul_tile.launches - n0[1])
        torch.cuda.synchronize()
        err = max(float((o - tqm.qmatmul_plain(x, q, s)).abs().max())
                  for o, (q, s) in zip(got, ws))
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        line = (f"K1 qmatmul {what} ({M},{K})x({K},{'|'.join(map(str, Ns))})"
                f" [{route}, launches qsplit/tile {n1} in two calls]: "
                f"max_abs_err {err:.3e}, repeat equal {same}")
        if route == "tile":
            norm = max(tqm.qmatmul_error(o, x, q, s)
                       for o, (q, s) in zip(got, ws))
            pnorm = max(tqm.qmatmul_error(tqm.qmatmul_plain(x, q, s), x, q,
                                          s) for q, s in ws)
            line += (f", normalised {norm:.3e} (qmm {pnorm:.3e}; bound "
                     f"{tqm.TILE_TOL:.3e})")
            check(norm <= tqm.TILE_TOL and all(
                bool(torch.isfinite(o).all()) for o in got),
                f"K1 {what}: the tile is past its bound ({norm:.3e})")
            worst_norm, plain_norm = max(worst_norm, norm), max(plain_norm,
                                                                pnorm)
        else:
            check(err == 0, f"K1 {what} disagrees with its plain version")
        print(line)
        check(same, f"K1 {what}: two launches gave different bits")
        check(n1 == ((2, 0) if route == "qsplit" else (0, 2 * len(Ns))),
              f"K1 {what}: launches {n1} on route {route}")
        worst[route] = max(worst[route], err)
    rows = bench_qmatmul.run(library=True)
    for r in rows:
        lib = ""
        if "library_ms" in r:
            lib = (f"; _weight_int8pack_mm {r['library_ms']} ms, cuBLAS "
                   f"bf16 (reference) {r['cublas_bf16_ms']:.5f} ms")
        print(f"  time {r['case']}: kernel {r['ms']:.5f} ms device (CUDA graph "
              f"replay, weights from HBM; {r['launches_a_call']} launches, "
              f"{r['weight_gb_s']:.0f} GB/s of int8 weights); bound "
              f"{r['bound_ms']:.5f} ms ({r['bound_by']}, "
              f"{100 * r['bound_ms'] / r['ms']:.1f}%){lib} [{card}]")
    by_case = {r["case"]: r for r in rows}
    plain = {}
    for case in ("codec_head", "talker prefill q|k|v R=41"):
        _, M, K, Ns = next(c for c in bench_qmatmul.CASES if c[0] == case)
        x, [(q, s)] = bench_qmatmul.inputs(g, M, K, Ns)
        qs = [q] + [q.clone() for _ in range((64 << 20) // (K * Ns[0]))]
        nxt = itertools.cycle(qs).__next__
        plain[case] = time_ms(lambda: tqm.qmatmul_plain(x, nxt(), s), 20,
                              graph=True)
        del qs
        print(f"  plain {case}: {plain[case]:.4f} ms [{card}]")
    head, tile = by_case["codec_head"], by_case["talker prefill q|k|v R=41"]
    x, [(q, s)] = bench_qmatmul.inputs(g, 1, 1024, [3072])
    lib = bench_qmatmul.library_ms(x, q, s)[0]
    print(f"  codec_head _weight_int8pack_mm {lib} ms [{card}]")
    return [{"name": "qmatmul", "route": "cuda",
             "source": "qwen3_tts_tpu_torch/csrc/qmatmul.cu",
             "replaces": "qwen3_tts_tpu/ops/pallas/qmatmul.py:48",
             "max_abs_err": worst["qsplit"], "ms": head["ms"],
             "plain_ms": plain["codec_head"], "bound_ms": head["bound_ms"],
             "bound_by": head["bound_by"], "library_ms": lib,
             "shape": "(1,1024)x(1024,3072) on qsplit",
             "cases": [r for r in rows if r["M"] <= 8]},
            {"name": "qmatmul_tile", "route": "cuda",
             "source": "qwen3_tts_tpu_torch/csrc/qmatmul.cu",
             "replaces": "qwen3_tts_tpu/ops/pallas/qmatmul.py:48",
             "max_abs_err": worst["tile"],
             "max_normalised_err": worst_norm,
             "qmm_normalised_err": plain_norm, "tolerance": tqm.TILE_TOL,
             "ms": tile["ms"], "plain_ms": plain["talker prefill q|k|v R=41"],
             "bound_ms": tile["bound_ms"], "bound_by": tile["bound_by"],
             "library_ms": tile.get("library_ms"),
             "shape": "(41,1024)x(1024,4096) talker prefill q|k|v",
             "cases": [r for r in rows if r["M"] > 8]}]


def phase_prefill_tile(eng, card: str) -> None:
    """The int8 talker's prefill at full geometry on one slice prefix
    (TEXTS[0]: a text bucket of 32 and 9 prefix positions) with K1 on the
    tile, then again on the same CUDA tensors with quant's K1 swapped for
    its plain version inside this check: the cosine and the largest
    relative error of the final hidden (after the final norm). The tile
    must run 4 a layer, and the cosine be >= 0.99."""
    import torch
    from qwen3_tts_tpu_torch.models import talker as tk
    from qwen3_tts_tpu_torch.models import transformer as tfm
    from qwen3_tts_tpu_torch.ops import quant
    from qwen3_tts_tpu_torch.ops.kernels import qmatmul as tqm
    cfg = eng.cfg.talker
    with torch.inference_mode():
        ids, n_text = eng._encode_text(TEXTS[0])
        prefix, plen = tk.build_prefix(
            eng._tp, torch.from_numpy(ids).to("cuda"), n_text)
        P = prefix.shape[0]
        positions = torch.arange(P, device="cuda")[None]
        mask = tfm.causal_mask(1, P, plen.reshape(1))
        geo = tfm.geometry_of(cfg)

        def hidden():
            h, _ = tfm.forward_prefill(eng._tp["layers"], prefix[None],
                                       positions, mask, geo)
            return tfm.rms_norm(h, eng._tp["final_norm"],
                                cfg.rms_norm_eps).float()

        n0 = tqm.qmatmul_tile.launches
        got = hidden()
        torch.cuda.synchronize()
        tiles = tqm.qmatmul_tile.launches - n0
        kernel_k1 = quant.qmatmul
        quant.qmatmul = tqm.qmatmul_plain
        try:
            ref = hidden()
        finally:
            quant.qmatmul = kernel_k1
        torch.cuda.synchronize()
    cos = float(torch.nn.functional.cosine_similarity(
        got.flatten().double(), ref.flatten().double(), dim=0))
    rel = float((got - ref).abs().max() / ref.abs().max())
    print(f"prefill on the tile: R={P} rows, {tiles} tile launches; final "
          f"hidden against K1's plain version: cosine {cos:.7f}, max rel "
          f"err {rel:.3e} [{card}]")
    check(P == 41, f"the slice prefix has {P} rows, not 41")
    check(tiles == 4 * cfg.num_layers,
          f"the prefill launched the tile {tiles} times")
    check(bool(torch.isfinite(got).all()), "non-finite prefill hidden")
    check(cos >= 0.99, f"prefill on the tile: cosine {cos:.5f} < 0.99")


CHUNK = 128                 # the reference's chunked-prefill window


def phase_chunked_prefill(eng, card: str, counters: dict) -> dict:
    """talker.prefill_chunked at full geometry on the int8 engine's
    weights: a 265-row prefix (256 seeded text ids) prefilled one-shot (K1
    on the tile at R = 265) and in windows of CHUNK = 128 rows (3 windows,
    the last zero-padded; K1 on the tile at R = 128, 4 launches a talker
    layer a window). Held: the final hidden at cosine >= 0.9999 against
    the one-shot prefill, and one decode step (K3) from each cache on the
    same feedback row at cosine >= 0.9999; printed: max |diff| of the
    hidden and of the real KV rows, the tile's launches, each prefill's
    device ms and the four products' device ms at R = 128 (CUDA events
    after a warm-up; each prefill also back to back without a graph,
    paced by the host). A window grid past the cache raises ValueError.
    Returns the kernels' launches in the chunked prefill."""
    import numpy as np
    import torch
    from qwen3_tts_tpu_torch.models import talker as tk
    from qwen3_tts_tpu_torch.models import transformer as tfm
    from qwen3_tts_tpu_torch.ops import quant
    cfg, tp = eng.cfg.talker, eng._tp
    geo = tfm.geometry_of(cfg)
    rng = np.random.default_rng(17)
    ids = rng.integers(1000, 100000, 256).astype(np.int32)
    fb = torch.from_numpy(rng.standard_normal((1, cfg.hidden_size)).astype(
        np.float32) * 0.3).to("cuda", tp["codec_embedding"].dtype)

    def cosine(a, b):
        return float(torch.nn.functional.cosine_similarity(
            a.flatten().double(), b.flatten().double(), dim=0))

    with torch.inference_mode():
        prefix, plen = tk.build_prefix(tp, torch.from_numpy(ids).to("cuda"),
                                       256)
        prefix, plen = prefix[None], plen.reshape(1)
        P = prefix.shape[1]
        check(P == 265 and int(plen[0]) == 265,
              f"chunked prefill: a prefix of {P} rows")

        def kv():
            return tfm.init_kv_cache(geo, 1, cfg.max_seq_len,
                                     dtype=prefix.dtype, device="cuda")

        def one_shot():
            return tk.prefill(tp, prefix, plen, kv(), cfg)

        def chunked():
            return tk.prefill_chunked(tp, prefix, plen, kv(), cfg,
                                      chunk=CHUNK)
        out, tiles = {}, {}
        for name, fn in (("one-shot", one_shot), ("chunked", chunked)):
            before = _launches(counters)
            h, cache = fn()
            torch.cuda.synchronize()
            tiles[name] = _grew(before, counters)
            step, _ = tk.decode_step(tp, fb, plen.to(torch.int32),
                                     cache.clone(), cfg)
            out[name] = (h.float(), cache, step.float())
        ms = {name: (time_ms(fn, 3), time_ms(fn, 3, graph=True))
              for name, fn in (("one-shot", one_shot), ("chunked", chunked))}
        layer = {k: v[0] for k, v in tp["layers"].items()}
        g = torch.Generator(device="cuda").manual_seed(17)
        x, xi, xo = (torch.randn((CHUNK, k), device="cuda", generator=g).to(
            prefix.dtype) for k in (cfg.hidden_size, cfg.intermediate_size,
                                    cfg.num_heads * cfg.head_dim))
        products = {"q|k|v": (x, layer["qkv_proj"]),
                    "o": (xo, layer["o_proj"]),
                    "gate|up": (x, layer["gateup_proj"]),
                    "down": (xi, layer["down_proj"])}
        prod_ms = {}
        for name, (xx, w) in products.items():
            n0 = counters["qmatmul_tile"].launches
            quant.matmul(xx, w)
            check(counters["qmatmul_tile"].launches == n0 + 1,
                  f"chunked prefill: {name} at R = {CHUNK} not on the tile")
            prod_ms[name] = time_ms(lambda: quant.matmul(xx, w), 20,
                                    graph=True)
        S = cfg.max_seq_len
        try:
            tk.prefill_chunked(tp, prefix, plen, kv(), cfg, chunk=260)
            raised = False
        except ValueError as e:
            raised = "chunked prefill" in str(e)
    (h1, kv1, d1), (h2, kv2, d2) = out["one-shot"], out["chunked"]
    cos, dcos = cosine(h2, h1), cosine(d2, d1)
    kv_diff = float((kv2[:, :, :, :P].float()
                     - kv1[:, :, :, :P].float()).abs().max())
    print(f"chunked prefill: R={P} in {-(-P // CHUNK)} windows of {CHUNK}: "
          f"final hidden cosine {cos:.7f}, max|diff| "
          f"{float((h2 - h1).abs().max()):.3e} (scale "
          f"{float(h1.abs().max()):.3f}); KV rows [0, {P}) max|diff| "
          f"{kv_diff:.3e}; a decode step after each: cosine {dcos:.7f}, "
          f"max|diff| {float((d2 - d1).abs().max()):.3e}; tile launches "
          f"one-shot {tiles['one-shot']['qmatmul_tile']} (R={P}), chunked "
          f"{tiles['chunked']['qmatmul_tile']} (R={CHUNK}); ms a call back "
          f"to back "
          f"(CUDA events, paced by the host's launches) one-shot "
          f"{ms['one-shot'][0]:.3f}, chunked {ms['chunked'][0]:.3f}; device "
          f"ms (CUDA-graph replay) one-shot {ms['one-shot'][1]:.3f}, "
          f"chunked {ms['chunked'][1]:.3f} [{card}]")
    print(f"chunked prefill: K1 tile at R={CHUNK}, layer 0's weights (warm "
          f"in L2), device ms (CUDA-graph replay timed by CUDA events after "
          f"a warm-up) {json.dumps(prod_ms)} [{card}]")
    layers = cfg.num_layers
    n1, n2 = (tiles[k]["qmatmul_tile"] for k in ("one-shot", "chunked"))
    check(n1 == 4 * layers, f"chunked prefill: one-shot tile launches {n1}")
    check(n2 == 4 * layers * -(-P // CHUNK),
          f"chunked prefill: chunked tile launches {n2}")
    check(bool(torch.isfinite(h2).all()), "chunked prefill: non-finite")
    check(cos >= 0.9999, f"chunked prefill: hidden cosine {cos:.6f}")
    check(dcos >= 0.9999, f"chunked prefill: decode step cosine {dcos:.6f}")
    check(raised, f"chunked prefill: 2 windows of 260 > S = {S} did not "
          "raise its ValueError")
    return tiles["chunked"]


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


def _launches(counters: dict) -> dict:
    return {k: fn.launches for k, fn in counters.items()}


def _grew(before: dict, counters: dict) -> dict:
    return {k: fn.launches - before[k] for k, fn in counters.items()}


def _check_result(res, label: str) -> None:
    import numpy as np
    n = res.n_tokens
    check(n >= 1, f"{label}: no tokens")
    check(res.codes.shape == (n, 16), f"{label}: codes shape "
          f"{res.codes.shape}")
    check(bool(((res.codes >= 0) & (res.codes < 2048)).all()),
          f"{label}: codes out of [0, 2048)")
    check(len(res.audio_int16) == n * 1920, f"{label}: duration math")
    check(bool(np.isfinite(res.audio_int16.astype(np.float64)).all()),
          f"{label}: non-finite audio")


def _surface_int8_cp(params, card: str, counters: dict) -> None:
    """TTSEngine(quantize="int8-cp") on TEXTS: K1 and K2 each request, K3
    never; an engine given the same weights with the code predictor
    already int8 reports "int8-cp" and gives equal codes."""
    import numpy as np
    import torch
    from qwen3_tts_tpu_torch.config import TTSConfig
    from qwen3_tts_tpu_torch.engine.engine import TTSEngine
    from qwen3_tts_tpu_torch.ops import quant
    cfg = TTSConfig()
    a = TTSEngine(cfg, params=params, quantize="int8-cp", device="cuda")
    b = TTSEngine(cfg, params=dict(params, code_predictor=(
        quant.quantize_code_predictor(params["code_predictor"]))),
                  device="cuda")
    check(a.quantize == b.quantize == "int8-cp",
          f"int8-cp labels {a.quantize!r} {b.quantize!r}")
    for i, text in enumerate(TEXTS):
        before = _launches(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = a.synthesize(text, seed=i, max_tokens=48)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        grew = _grew(before, counters)
        _check_result(res, f"int8-cp request {i}")
        for k in ("qmatmul", "cp_decode"):
            check(grew[k] > 0, f"int8-cp request {i}: {k} not launched")
        check(grew["talker_step"] == 0,
              f"int8-cp request {i}: K3 launched {grew['talker_step']}")
        same = b.synthesize(text, seed=i, max_tokens=48)
        check(np.array_equal(same.codes, res.codes),
              f"int8-cp request {i}: the pre-quantized code predictor "
              "gave other codes")
        print(f"int8-cp request {i}: n_tokens={res.n_tokens} wall "
              f"{wall:.3f} s ({1000 * wall / res.n_tokens:.2f} ms/token) "
              f"launches { {k: v for k, v in grew.items() if v} }; the "
              f"pre-quantized code predictor: equal codes [{card}]")


def _surface_prefix_cache(eng, card: str, counters: dict) -> None:
    """The int8 engine's prefix LRU: A, B, A (equal codes and audio: the
    snapshot is not changed by the decodes between), a hit under another
    seed equals that seed's cold request, a hit under a smaller cap stops
    there, a streaming hit gives the whole request's codes; a hit launches
    no prefill tile."""
    import numpy as np
    import torch
    L = eng.cfg.talker.num_layers

    def run(text, seed, **kw):
        before = _launches(counters)
        res = eng.synthesize(text, seed=seed, **kw)
        torch.cuda.synchronize()
        return res, _grew(before, counters)["qmatmul_tile"]

    eng._prefix_cache.clear()
    a1, t_cold = run(TEXTS[0], 0)
    run(TEXTS[1], 1)
    a2, t_hit = run(TEXTS[0], 0)
    check(t_cold == 4 * L and t_hit == 0,
          f"prefix cache: tile launches cold {t_cold}, hit {t_hit}")
    check(np.array_equal(a1.codes, a2.codes)
          and np.array_equal(a1.audio_int16, a2.audio_int16),
          "prefix cache: A, B, A gave other codes or audio")
    hit5, _ = run(TEXTS[0], 5)
    eng._prefix_cache.clear()
    cold5, _ = run(TEXTS[0], 5)
    check(np.array_equal(hit5.codes, cold5.codes)
          and np.array_equal(hit5.audio_int16, cold5.audio_int16),
          "prefix cache: a hit under seed 5 is not the cold seed-5 request")
    capped, _ = run(TEXTS[0], 0, max_tokens=5)
    check(1 <= capped.n_tokens <= 5 and np.array_equal(
        capped.codes, a1.codes[:capped.n_tokens]),
        f"prefix cache: a hit under max_tokens=5 gave {capped.n_tokens} "
        "tokens or other codes")
    pieces = []
    streamed, t_stream = run(TEXTS[0], 0, streaming=True,
                             on_chunk=pieces.append)
    check(t_stream == 0 and np.array_equal(streamed.codes, a1.codes),
          "prefix cache: the streaming hit prefilled or gave other codes")
    check(np.array_equal(np.concatenate(pieces), streamed.audio_int16),
          "prefix cache: the streaming hit's pieces are not its audio")
    eng._prefix_cache.clear()
    pieces = []
    s_cold, _ = run(TEXTS[0], 0, streaming=True, on_chunk=pieces.append)
    ms = {k: round(1000 * v, 3) for k, v in (
        ("decode+vocoder cold", a1.timings["decode+vocoder"]),
        ("decode+vocoder hit", a2.timings["decode+vocoder"]),
        ("prefill cold (streaming)", s_cold.timings["prefill"]),
        ("prefill hit (streaming)", streamed.timings["prefill"]))}
    print(f"prefix cache: A, B, A equal; a seed-5 hit equals the cold "
          f"seed-5 request; a hit under max_tokens=5 kept "
          f"{capped.n_tokens} tokens; the tile {t_cold} launches cold, 0 "
          f"on a hit; stage ms {ms} (n_tokens {a1.n_tokens}); first audio "
          f"streamed cold {s_cold.first_audio_seconds:.4f} s, hit "
          f"{streamed.first_audio_seconds:.4f} s [{card}]")


def _surface_disk(eng, card: str, counters: dict) -> None:
    """kv_cache_dir: a cold request writes one qwen3_kv_*.npz; with the
    LRU emptied, the same request restores it (no prefill tile) with
    equal codes and audio."""
    import tempfile
    import numpy as np
    import torch
    with tempfile.TemporaryDirectory() as d:
        eng.kv_cache_dir = d
        try:
            eng._prefix_cache.clear()
            t0 = time.perf_counter()
            a = eng.synthesize(TEXTS[2], seed=2)
            torch.cuda.synchronize()
            t_write = time.perf_counter() - t0
            files = [f for f in os.listdir(d) if f.startswith("qwen3_kv_")]
            check(len(files) == 1, f"disk cache: {len(files)} files")
            size = os.path.getsize(os.path.join(d, files[0]))
            eng._prefix_cache.clear()
            before = _launches(counters)
            t0 = time.perf_counter()
            b = eng.synthesize(TEXTS[2], seed=2)
            torch.cuda.synchronize()
            t_read = time.perf_counter() - t0
            tiles = _grew(before, counters)["qmatmul_tile"]
        finally:
            eng.kv_cache_dir = None
    check(tiles == 0, f"disk cache: the restore launched the tile {tiles} "
          "times")
    check(np.array_equal(a.codes, b.codes)
          and np.array_equal(a.audio_int16, b.audio_int16),
          "disk cache: the restored request gave other codes or audio")
    print(f"disk cache: one file of {size} bytes; cold request with the "
          f"write {t_write:.3f} s, restored request {t_read:.3f} s "
          f"(n_tokens {a.n_tokens}), equal codes and audio [{card}]")


def _serve_cloned(b, cloned, plain, label, counters):
    """One cloned request among plain ones through batcher b; returns
    (codes per request, the cloned request, launches)."""
    import torch
    for fn in counters.values():
        fn.launches = 0
    futs = [b.submit(*p, seed=i, max_tokens=32)
            for i, p in enumerate(plain[:2])]
    fc = b.submit(*cloned[:2], seed=7, max_tokens=32, ref_codes=cloned[2],
                  n_target=cloned[3])
    futs += [fc] + [b.submit(*p, seed=3 + i, max_tokens=32)
                    for i, p in enumerate(plain[2:])]
    steps = 0
    while not all(f.done() for f in futs):
        check(steps < 200, f"{label}: not done after 200 steps")
        b.step()
        steps += 1
    torch.cuda.synchronize()
    codes = []
    for i, f in enumerate(futs):
        c, a = f.result(timeout=0)
        check(len(c) >= 1 and len(a) == len(c) * 1920,
              f"{label}: request {i} duration math")
        codes.append(c)
    return codes, fc.request, _launches(counters)


def _surface_cloning(eng, params, card: str, counters: dict) -> None:
    """synthesize(prompt_dir=...) whole and streaming (equal codes, audio
    within +-1 LSB; the cloned prefill on the tile 4 launches a talker
    layer, the second request a hit); the engine's cloned prefix against
    the dense batcher's admission prefix, bit for bit; one cloned request
    among plain ones through the dense (K5) and the paged (K4) batcher,
    each run twice with equal codes."""
    import tempfile
    import numpy as np
    import torch
    from qwen3_tts_tpu_torch.config import TalkerConfig, TTSConfig
    from qwen3_tts_tpu_torch.models import talker as tk
    from qwen3_tts_tpu_torch.serve.batching import ContinuousBatcher
    from qwen3_tts_tpu_torch.tools import bench_e2e
    L = eng.cfg.talker.num_layers
    frames = np.random.default_rng(7).integers(
        0, 2048, (CLONE_FRAMES, 16)).astype(np.int64)
    with tempfile.TemporaryDirectory() as d:
        np.save(os.path.join(d, "ref_codec_tokens.npy"), frames)
        with open(os.path.join(d, "ref_text.txt"), "w") as f:
            f.write(CLONE_TEXT)
        eng._prefix_cache.clear()
        before = _launches(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        whole = eng.synthesize(TEXTS[0], seed=0, prompt_dir=d)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tiles = _grew(before, counters)["qmatmul_tile"]
        pieces = []
        before = _launches(counters)
        streamed = eng.synthesize(TEXTS[0], seed=0, prompt_dir=d,
                                  streaming=True, on_chunk=pieces.append)
        torch.cuda.synchronize()
        tiles_hit = _grew(before, counters)["qmatmul_tile"]
        ref_codes, ref_text = eng._load_prompt(d)
    _check_result(whole, "cloned request")
    ids, n_text, n_target = eng._encode_cloned(TEXTS[0], ref_text)
    padded, _ = tk.bucket_ref_frames(
        tk.cloned_ref_limit(eng.cfg.talker.max_seq_len, len(ids)), ref_codes)
    R = len(ids) + tk.PREFIX_EXTRA + len(padded)
    check(tiles == 4 * L, f"cloned prefill: the tile launched {tiles} times")
    check(tiles_hit == 0, "cloned request: the second one was no hit")
    check(np.array_equal(streamed.codes, whole.codes),
          "cloned request: streaming gave other codes")
    check(np.array_equal(np.concatenate(pieces), streamed.audio_int16),
          "cloned request: the pieces are not the audio")
    dmax, share = int16_delta(streamed.audio_int16, whole.audio_int16)
    check(dmax <= 1, f"cloned stream off by {dmax} > 1 LSB")
    print(f"cloned request: prefix R={R} rows (text bucket {len(ids)}, "
          f"{CLONE_FRAMES} reference frames), the tile {tiles} launches, "
          f"n_tokens {whole.n_tokens}, wall {wall:.3f} s; streamed on a "
          f"hit (tile 0): equal codes, int16 max|diff| {dmax}, differing "
          f"share {share:.6f} [{card}]")

    cfg = TTSConfig(talker=TalkerConfig(attention_impl="pallas"))
    plain = [bench_e2e.encode_text(t) for t in TEXTS]
    cloned = (ids, n_text, ref_codes, n_target)
    for paged in (False, True):
        label = "paged batcher (cloned)" if paged else \
            "dense batcher (cloned)"
        kw = dict(paged=True, page_size=64) if paged else {}
        b = ContinuousBatcher(cfg, params, batch_size=4, decode_chunk=16,
                              device="cuda", **kw)
        codes, req, launches = _serve_cloned(b, cloned, plain, label,
                                             counters)
        if not paged:
            # the engine's cached state was built on the frames the
            # batcher bucketed, and both sides' weights and ids give one
            # prefix
            padded, n_ref = req.cloned_prep
            check((tuple(ids.tolist()), n_text, n_target, padded.tobytes(),
                   n_ref) in eng._prefix_cache,
                  "the engine bucketed the reference otherwise")
            got, got_len = tk.request_prefix(
                b._tp, b._cpp["codec_embs"], req.text_ids, req.n_text,
                req.cloned_prep)
            want, want_len = tk.request_prefix(
                eng._tp, eng._cpp["codec_embs"], ids, n_text,
                req.cloned_prep)
            check(torch.equal(got, want) and int(got_len) == int(want_len),
                  "the batcher's cloned prefix is not the engine's")
            print(f"cloned prefix: the engine's and the dense batcher's "
                  f"admission prefix equal bit for bit ({tuple(got.shape)}, "
                  f"prefix_len {int(got_len)}) [{card}]")
        else:
            b._free_by_group[0].reverse()  # other pages the second time
        codes2, _, _ = _serve_cloned(b, cloned, plain, label, counters)
        check(all(np.array_equal(x, y) for x, y in zip(codes, codes2)),
              f"{label}: a rerun gave other codes")
        att = "paged_attention" if paged else "decode_attention"
        for k in (att, "cp_decode", "qmatmul"):
            check(launches[k] > 0, f"{label}: {k} not launched")
        print(f"{label}: 1 cloned request (n_tokens {len(codes[2])}) among "
              f"{len(plain)} plain ones, twice with equal codes; launches "
              f"{ {k: v for k, v in launches.items() if v} } [{card}]")
        del b


def _surface_long(eng, card: str, counters: dict) -> None:
    """synthesize_long on PARAGRAPH: at least 3 pieces and a group of at
    least 2 through synthesize_batch (K3 at B >= 2); the result is its
    pieces in order; again with on_chunk: equal codes, the chunks make up
    its audio, within +-1 LSB of the run without a consumer."""
    import numpy as np
    import torch
    parts, groups = [], []
    real_synth, real_batch = eng.synthesize, eng.synthesize_batch

    def synth(*a, **k):
        r = real_synth(*a, **k)
        parts.append(r)
        return r

    def batch(texts, *a, **k):
        before = counters["talker_step"].launches
        rs = real_batch(texts, *a, **k)
        groups.append((len(texts), counters["talker_step"].launches - before))
        parts.extend(rs)
        return rs
    runs = {}
    for mode in ("plain", "on_chunk"):
        chunks = []
        eng._prefix_cache.clear()
        eng.synthesize, eng.synthesize_batch = synth, batch
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = eng.synthesize_long(
                PARAGRAPH, seed=0,
                on_chunk=chunks.append if mode == "on_chunk" else None)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            del eng.synthesize, eng.synthesize_batch
        _check_result(res, f"synthesize_long ({mode})")
        check(np.array_equal(res.codes,
                             np.concatenate([p.codes for p in parts])),
              f"synthesize_long ({mode}): codes are not its pieces'")
        if mode == "plain":
            check(np.array_equal(res.audio_int16, np.concatenate(
                [p.audio_int16 for p in parts])),
                "synthesize_long: audio is not its pieces'")
        else:
            check(np.array_equal(np.concatenate(chunks), res.audio_int16),
                  "synthesize_long: the chunks are not its audio")
        check(len(parts) >= 3, f"synthesize_long: {len(parts)} pieces")
        check(any(n >= 2 and k3 > 0 for n, k3 in groups),
              f"synthesize_long: no batched group on K3 ({groups})")
        runs[mode] = res
        print(f"synthesize_long ({mode}): {len(parts)} pieces, groups "
              f"(size, K3 launches) {groups}, n_tokens {res.n_tokens}, "
              f"{res.audio_seconds:.2f} s of audio, wall {wall:.3f} s, RTF "
              f"{res.rtf:.4f}, first_audio_seconds "
              f"{res.first_audio_seconds:.4f} [{card}]")
        parts.clear()
        groups.clear()
    check(np.array_equal(runs["plain"].codes, runs["on_chunk"].codes),
          "synthesize_long: on_chunk changed the codes")
    dmax, share = int16_delta(runs["on_chunk"].audio_int16,
                              runs["plain"].audio_int16)
    check(dmax <= 1, f"synthesize_long: on_chunk audio off by {dmax}")
    print(f"synthesize_long: with on_chunk equal codes, int16 max|diff| "
          f"{dmax}, differing share {share:.6f} [{card}]")


def phase_engine_surface(eng, params, card: str, counters: dict) -> None:
    """The engine's request surface at full geometry, before any profiler
    session: int8-cp, the prefix cache in memory and on disk, voice
    cloning (engine, dense and paged batcher) and synthesize_long."""
    t0 = time.perf_counter()
    for part in (lambda: _surface_int8_cp(params, card, counters),
                 lambda: _surface_prefix_cache(eng, card, counters),
                 lambda: _surface_disk(eng, card, counters),
                 lambda: _surface_cloning(eng, params, card, counters),
                 lambda: _surface_long(eng, card, counters)):
        part()
    print(f"engine surface: {time.perf_counter() - t0:.1f} s")


def phase_cli(card: str) -> None:
    """The command line at full geometry: --long --quantize int8 under
    --profile; a WAV of audio and a trace file."""
    import tempfile
    from qwen3_tts_tpu_torch import cli
    with tempfile.TemporaryDirectory() as d:
        wav, prof = os.path.join(d, "cli.wav"), os.path.join(d, "prof")
        t0 = time.perf_counter()
        rc = cli.main(["--long", "--quantize", "int8", "--profile", prof,
                       "--output", wav])
        wall = time.perf_counter() - t0
        check(rc == 0, f"cli: exit {rc}")
        size = os.path.getsize(wav)
        traces = os.listdir(prof)
        check(size > 44, f"cli: WAV of {size} bytes")
        check(any(t.endswith(".json") for t in traces),
              f"cli: no trace in {traces}")
        print(f"cli --long --quantize int8 --profile: exit 0, WAV {size} "
              f"bytes, trace {traces}, {wall:.1f} s with the engine's "
              f"set-up [{card}]")


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
# layers x q|k|v, o, gate|up, down), all on qsplit: 22 (a replay of the
# prelude's CUDA graph counts the 21 it launches); the talker prefill
# adds 4 a layer a request (the tile)
K1_PER_STEP = 23


def phase_slice(eng, card: str, counters: dict) -> dict:
    import numpy as np
    import torch
    for fn in counters.values():
        fn.launches = 0
    tokens = 0
    for i, text in enumerate(TEXTS):
        eng._prefix_cache.clear()      # a cold request: it prefills
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
        for k in ("qmatmul", "qmatmul_qsplit", "qmatmul_tile", "talker_step",
                  "cp_decode"):
            check(grew[k] > 0, f"kernel {k} was not launched by request {i}")
        check(grew["qmatmul_tile"] == 4 * eng.cfg.talker.num_layers,
              f"request {i} launched the tile {grew['qmatmul_tile']} times")
        tokens += n
    k1 = counters["qmatmul"].launches
    steps = counters["talker_step"].launches   # one K3 launch a step
    cap = K1_PER_STEP * steps + 4 * eng.cfg.talker.num_layers * len(TEXTS)
    print(f"slice: K1 {k1} launches for {steps} decode steps ({tokens} "
          f"tokens kept; {k1 / steps:.2f} a step; qsplit "
          f"{counters['qmatmul_qsplit'].launches}, tile "
          f"{counters['qmatmul_tile'].launches}); at most {cap} "
          f"({K1_PER_STEP} a step and 4 a talker layer a request)")
    check(k1 <= cap, f"K1 launched {k1} times in the slice (cap {cap})")
    return {k: fn.launches for k, fn in counters.items()}


def int16_delta(got, want) -> tuple:
    """(max |got - want|, share of samples that differ) of two int16
    arrays of one length."""
    import numpy as np
    check(got.shape == want.shape, f"audio lengths {got.shape} {want.shape}")
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    return (int(d.max()) if d.size else 0,
            float((d > 0).mean()) if d.size else 0.0)


STREAM_MODES = ("plain", "window", "incremental")


def phase_stream_engine(eng, card: str, counters: dict) -> dict:
    """The int8 engine's three request modes at full geometry, in turns on
    each text: "plain" (non-streaming, the chained vocoder), "window"
    (streaming with on_chunk, the default prefix windows) and
    "incremental" (streaming with on_chunk, QWEN3_TTS_ENGINE_STREAM=
    incremental); one short request of each first, as a warm-up. Then one
    long request of each past the head chunks (LONG_TEXT, at most
    LONG_TOKENS tokens): the last decode call, the windows or stream steps
    up to the EOS-pacing bound, trimmed to the token count. Then the first
    text once more with the chain off (QWEN3_TTS_FUSED_VOCODER=0's path:
    fetch, then synthesize_exact), held to the chained request. Returns
    each mode's launches over the three texts."""
    import numpy as np
    import torch
    from qwen3_tts_tpu_torch.engine import engine as tengine

    def run(mode, text, seed, chained=True, **kw):
        pieces = []
        if mode != "plain":
            kw.update(streaming=True, on_chunk=pieces.append)
        eng._prefix_cache.clear()      # cold requests: each prefills
        eng._chained_vocode = chained
        if mode == "incremental":
            os.environ["QWEN3_TTS_ENGINE_STREAM"] = "incremental"
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = eng.synthesize(text, seed=seed, **kw)
            torch.cuda.synchronize()
        finally:
            os.environ.pop("QWEN3_TTS_ENGINE_STREAM", None)
            eng._chained_vocode = True
        return res, pieces, time.perf_counter() - t0

    def held(res, want, label):
        """The codes equal, and (max |diff|, differing share) of the int16
        audio against ``want``'s."""
        check(np.array_equal(res.codes, want.codes),
              f"{label}: codes differ from the chained request's")
        return int16_delta(res.audio_int16, want.audio_int16)

    def request(i, text, label, **kw):
        """The three modes in turns; each stream is held to the chained
        request. Returns {mode: (result, launches)}."""
        out, want = {}, None
        for mode in STREAM_MODES:
            before = _launches(counters)
            res, pieces, wall = run(mode, text, i, **kw)
            grew = _grew(before, counters)
            out[mode] = (res, grew)
            line = (f"stream {mode} {label}: n_tokens={res.n_tokens} "
                    f"first_audio_seconds={res.first_audio_seconds:.4f} "
                    f"wall={wall:.3f}s RTF={res.rtf:.4f}")
            check(res.n_tokens >= 1, f"stream {mode} {label}: no tokens")
            check(res.first_audio_seconds is not None,
                  f"stream {mode} {label}: no first_audio_seconds")
            for k in ("qmatmul_qsplit", "qmatmul_tile", "talker_step",
                      "cp_decode"):
                check(grew[k] > 0, f"stream {mode} {label}: {k} was not "
                      "launched")
            if mode == "plain":
                check("decode+vocoder" in res.timings,
                      f"stream plain {label}: not chained ({res.timings})")
                want = res
            else:
                check(np.array_equal(np.concatenate(pieces),
                                     res.audio_int16),
                      f"stream {mode} {label}: pieces are not the audio")
                dmax, share = held(res, want, f"stream {mode} {label}")
                line += (f" pieces={len(pieces)} int16 max|diff|={dmax} "
                         f"differing share={share:.6f}")
                check(dmax <= 1 and (mode != "window"
                                     or share < WINDOW_SHARE),
                      f"stream {mode} {label}: int16 off by {dmax} on "
                      f"{share:.6f}")
            print(f"{line} [{card}]")
        return out

    for mode in STREAM_MODES:
        run(mode, TEXTS[0], 9, max_tokens=16)
    run("plain", TEXTS[0], 9, chained=False, max_tokens=16)
    for fn in counters.values():
        fn.launches = 0
    rows = {m: [] for m in STREAM_MODES}
    per_mode = {m: dict.fromkeys(counters, 0) for m in STREAM_MODES}
    for i, text in enumerate(TEXTS):
        for mode, (res, grew) in request(i, text, f"request {i}").items():
            rows[mode].append(res)
            for k, v in grew.items():
                per_mode[mode][k] += v
    rtf = {m: statistics.median(r.rtf for r in rows[m])
           for m in STREAM_MODES}
    fa = {m: statistics.median(r.first_audio_seconds for r in rows[m])
          for m in STREAM_MODES}
    for m in STREAM_MODES:
        print(f"stream {m}: first_audio_seconds "
              f"{[round(r.first_audio_seconds, 4) for r in rows[m]]} "
              f"median {fa[m]:.4f} s; median RTF {rtf[m]:.4f} "
              f"({rtf[m] / rtf['plain']:.3f}x the non-streaming RTF); "
              f"launches { {k: v for k, v in per_mode[m].items() if v} } "
              f"[{card}]")
    print(json.dumps({"metric": "stream_first_audio_seconds_p50", **fa,
                      "card": card}))
    print(json.dumps({"metric": "stream_rtf_p50", **rtf, "card": card}))
    long = request(len(TEXTS), LONG_TEXT, "long request",
                   max_tokens=LONG_TOKENS)
    n = long["window"][0].n_tokens
    check(n > sum(eng.head_schedule),
          f"stream long request: {n} tokens end inside the head")
    W = tengine._chained_voc_window(
        LONG_TOKENS, eng._encode_text(LONG_TEXT)[1], eng.cfg.sampling)
    print(f"stream long request: the chain's window {W} tokens for {n} "
          f"[{card}]")
    res, _, wall = run("plain", TEXTS[0], 0, chained=False)
    want = rows["plain"][0]
    check("vocoder" in res.timings, f"unchained request: {res.timings}")
    dmax, share = held(res, want, "unchained request 0")
    print(f"stream unchained request 0: wall={wall:.3f}s against the "
          f"chained {want.total_seconds:.3f}s; stages "
          f"{ {k: round(v, 4) for k, v in res.timings.items()} } against "
          f"{ {k: round(v, 4) for k, v in want.timings.items()} }; int16 "
          f"max|diff| {dmax} on {share:.6f} [{card}]")
    check(dmax <= WINDOW_LSB and share < WINDOW_SHARE,
          f"unchained request: int16 off by {dmax} on {share:.6f}")
    _vocoder_widths(eng, card)
    return per_mode


def _vocoder_widths(eng, card: str) -> None:
    """Why the window stream is not bit for bit on the card: 150 seeded
    codes vocoded in windows of 192 and 256 tokens (the kept samples'
    int16 gap), and the vocoder's first product (layer 0's q_proj, f32,
    TF32 off) at 192 and 256 rows (the share of its first 150 rows'
    elements that differ)."""
    import numpy as np
    import torch
    from qwen3_tts_tpu_torch.models import vocoder as voc
    codes = np.random.default_rng(3).integers(0, 2048, (150, 16)).astype(
        np.int32)
    a, b = (eng._voc(voc.pad_window(codes, W, "cuda"))[
        0, :150 * 1920].cpu().numpy() for W in (192, 256))
    dmax, share = int16_delta(a, b)
    w = eng._vp["pre"]["layers"]["q_proj"][0]
    x = torch.randn((256, w.shape[0]), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(3))
    with voc._fp32_exact():
        d = (x[:192] @ w)[:150] - (x @ w)[:150]
    print(f"vocoder widths 192 against 256 over 150 codes: int16 max|diff| "
          f"{dmax} on {share:.6f}; layer 0 q_proj at 192 against 256 rows: "
          f"{float((d != 0).float().mean()):.4f} of the elements differ, "
          f"max {float(d.abs().max()):.3e} [{card}]")


def phase_stream_batcher(params, card: str, counters: dict) -> None:
    """The continuous batcher with streaming requests at full geometry:
    dense (attention_impl="pallas", K5), then paged (K4); six requests of
    at most 48 tokens through 4 slots, requests 1 and 4 streaming."""
    import numpy as np
    import torch
    from qwen3_tts_tpu_torch.config import TalkerConfig, TTSConfig
    from qwen3_tts_tpu_torch.engine.engine import vocode
    from qwen3_tts_tpu_torch.serve.batching import ContinuousBatcher
    from qwen3_tts_tpu_torch.tools import bench_e2e
    cfg = TTSConfig(talker=TalkerConfig(attention_impl="pallas"))
    streaming = (1, 4)
    for paged in (False, True):
        label = "paged" if paged else "dense"
        kw = dict(paged=True, page_size=64) if paged else {}
        b = ContinuousBatcher(cfg, params, batch_size=4, decode_chunk=16,
                              device="cuda", **kw)
        pieces = {i: [] for i in streaming}
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        futs = [b.submit(*bench_e2e.encode_text(t), seed=i, max_tokens=48,
                         on_chunk=(pieces[i].append if i in streaming
                                   else None))
                for i, t in enumerate(BATCH_TEXTS)]
        steps = 0
        while not all(f.done() for f in futs):
            check(steps < 200, f"stream {label} batcher: not done after "
                  "200 steps")
            b.step()
            steps += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        for k in ("paged_attention" if paged else "decode_attention",
                  "cp_decode", "qmatmul"):
            check(launches[k] > 0, f"stream {label} batcher: {k} was not "
                  "launched")
        for i, f in enumerate(futs):
            codes, audio = f.result(timeout=0)
            check(len(codes) >= 1 and len(audio) == len(codes) * 1920,
                  f"stream {label} batcher: request {i} duration math")
            if i not in streaming:
                continue
            r = f.request
            check(np.array_equal(np.concatenate(pieces[i]), audio),
                  f"stream {label} batcher: request {i}'s segments are not "
                  "its audio")
            want = vocode(b._vp, codes, cfg.vocoder, "cuda")
            dmax, share = int16_delta(audio, want)
            print(f"stream {label} batcher request {i}: n_tokens="
                  f"{len(codes)} segments={len(pieces[i])} first segment "
                  f"{r.t_first_audio - r.t_submit:.4f} s after submit ("
                  f"{r.t_first_audio - r.t_admit:.4f} s after admission), "
                  f"done {r.t_done - r.t_submit:.4f} s; int16 max|diff| "
                  f"{dmax} against its non-streaming vocoding, differing "
                  f"share {share:.6f} [{card}]")
            check(dmax <= 1, f"stream {label} batcher: request {i} off by "
                  f"{dmax} > 1 LSB")
        check(all(r is None for r in b._slot_req),
              f"stream {label} batcher: a slot is busy")
        print(f"stream {label} batcher: {len(futs)} requests "
              f"({len(streaming)} streaming), {steps} scheduler steps, "
              f"wall {wall:.3f} s, "
              f"launches {launches} [{card}]")
        del b


def phase_chunked_vocoder(eng, card: str) -> None:
    """synthesize_exact past one window: 300 seeded codes in left-context
    chunks of 64 with 25 tokens of context. synthesize_chunked_context
    with all 300 tokens as context is sample-exact by construction:
    int16 within +-1 LSB of the one-window decode of all 300 (f32, TF32
    off). The 25-token context truncates the pre-transformer's receptive
    field (its window is 72 tokens): held to the JAX package's bound for
    it, f32 atol 1e-4 (tests/test_vocoder_golden.py,
    test_chunked_context_near_exact_bounded). A witness on the host: the
    same weights and codes through the port on the CPU, where
    synthesize_exact and the one window each agree with the card's
    within +-1 LSB, and the truncation's gap is the card's within 10%."""
    import copy
    import numpy as np
    import torch
    from qwen3_tts_tpu_torch.models import vocoder as voc
    codes = np.random.default_rng(11).integers(
        0, 2048, (300, 16)).astype(np.int32)
    vp, vcfg = eng._vp, eng.cfg.vocoder
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = voc.synthesize_exact(voc.int16_decoder(vp, vcfg), codes,
                               device="cuda")
    wall = time.perf_counter() - t0
    check(len(got) == 300 * 1920, "chunked vocoder: duration math broken")
    W = voc.voc_bucket(301)

    def decoder(params):
        return lambda ch: voc.decode(params, ch, vcfg)

    def one_window(params, device):
        out = decoder(params)(voc.pad_window(codes, W, device))
        return out[0, :300 * 1920].cpu().numpy()
    dec = decoder(vp)
    full = one_window(vp, "cuda")
    exact = voc.synthesize_chunked_context(dec, codes, 64, 300,
                                           device="cuda")
    approx = voc.synthesize_exact(dec, codes, device="cuda")
    check(np.array_equal(voc.to_int16(approx), got),
          "chunked vocoder: the int16 decoder's audio is not the f32 one's")
    e_max, e_share = int16_delta(voc.to_int16(exact), voc.to_int16(full))
    a_err = float(np.abs(approx - full).max())
    a_max, a_share = int16_delta(got, voc.to_int16(full))
    print(f"chunked vocoder: synthesize_exact over 300 codes {wall:.3f} s "
          f"wall; context 300 against one window: f32 max|diff| "
          f"{float(np.abs(exact - full).max()):.3e}, int16 max|diff| "
          f"{e_max} on {e_share:.6f}; context 25 (synthesize_exact): f32 "
          f"max|diff| {a_err:.3e}, int16 max|diff| {a_max} on "
          f"{a_share:.6f} [{card}]")
    check(e_max <= 1, f"chunked vocoder: context 300 off by {e_max} > 1 "
          "LSB")
    check(a_err <= 1e-4, f"chunked vocoder: context 25 off by {a_err} > "
          "1e-4")
    t0 = time.perf_counter()
    vp_cpu = copy.deepcopy(eng.vocoder).to("cpu").weights()
    full_cpu = one_window(vp_cpu, "cpu")
    approx_cpu = voc.synthesize_exact(decoder(vp_cpu), codes, device="cpu")
    gap_cpu = float(np.abs(approx_cpu - full_cpu).max())
    f_max, _ = int16_delta(voc.to_int16(full), voc.to_int16(full_cpu))
    x_max, x_share = int16_delta(voc.to_int16(approx),
                                 voc.to_int16(approx_cpu))
    print(f"chunked vocoder on the CPU ({time.perf_counter() - t0:.1f} s, "
          f"{torch.get_num_threads()} threads): context 25 against one "
          f"window f32 max|diff| {gap_cpu:.3e} (the card's "
          f"{a_err:.3e}); card against CPU: one window f32 max|diff| "
          f"{float(np.abs(full - full_cpu).max()):.3e}, synthesize_exact "
          f"{float(np.abs(approx - approx_cpu).max()):.3e}, int16 max|diff| "
          f"{x_max} on {x_share:.6f} [{card}]")
    check(f_max <= 1 and x_max <= 1, "chunked vocoder: the card and the "
          f"CPU differ by {max(f_max, x_max)} > 1 LSB")
    check(abs(a_err - gap_cpu) <= 0.1 * gap_cpu, "chunked vocoder: the "
          f"card's truncation gap {a_err} is not the CPU's {gap_cpu}")


def phase_profile(eng, card: str) -> None:
    """One more request under torch.profiler: device busy time (the union
    of the kernels' intervals), device time by kernel (the launch counts
    of the checked requests are read before it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from qwen3_tts_tpu_torch.tools import bench_e2e
    eng._prefix_cache.clear()          # a cold request: it prefills
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


def phase_kv_int8(card: str, k5_shapes: list) -> dict:
    """K6 (the int8 mode of K5's split) at the talker's geometry (Hq 16,
    Hkv 8, Dh 128) against its plain version, f32 and bf16 q: S 512 at B
    = 1, 4 and 8 (positions with 0 and 511, and every row at 511), S 577
    (ragged chunks of 73) and S 8192 (error 0 expected: the plain version
    is K5's over the dequantized rows); rows past pos poisoned change no
    bit. Then its time at the shapes of tools/bench_decode_attention
    (int8 K/V from HBM, CUDA-graph replay) beside its bound and K5's time
    at the same positions (``k5_shapes``, this run's). No single PyTorch
    call reads an int8 cache with per-row scales: SDPA over the rows
    dequantized to bf16 is printed as a reference only."""
    import torch
    from qwen3_tts_tpu_torch.ops.kernels.kv_int8 import (
        decode_attention_kv_int8_cuda, decode_attention_kv_int8_plain,
        quantize_kv_rows)
    from qwen3_tts_tpu_torch.tools import bench_decode_attention
    g = torch.Generator(device="cuda").manual_seed(11)
    Hq, Hkv, Dh = 16, 8, 128
    POS = [0, 511, 200, 37, 450, 1, 300, 64]
    CASES = ((512, [511]), (512, POS[:4]), (512, POS), (512, [511] * 8),
             (577, [576, 72, 73]), (8192, [8191, 3000]))

    def cache(B, S):
        kf = torch.randn((B, Hkv, S, Dh), generator=g, device="cuda") * 0.5
        vf = torch.randn((B, Hkv, S, Dh), generator=g, device="cuda") * 0.5
        return kf, vf

    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for S, pl in CASES:
            B = len(pl)
            q = torch.randn((B, Hq, Dh), generator=g, device="cuda").to(dtype)
            kf, vf = cache(B, S)
            args = (q, *quantize_kv_rows(kf), *quantize_kv_rows(vf),
                    torch.tensor(pl, device="cuda"))
            ref = decode_attention_kv_int8_plain(*args)
            got = decode_attention_kv_int8_cuda(*args)
            torch.cuda.synchronize()
            err = float((got.float() - ref.float()).abs().max())
            print(f"K6 decode_attention_kv_int8 {str(dtype)[6:]} S={S} B={B} "
                  f"pos={pl}: max_abs_err {err:.3e}")
            check(got.dtype == dtype and err == 0,
                  f"K6 disagrees with its plain version ({dtype}, S={S}, "
                  f"B={B})")
            worst = max(worst, err)
    # poison: rows past pos at +-99 before quantizing change no bit
    B = 4
    q = torch.randn((B, Hq, Dh), generator=g, device="cuda").bfloat16()
    kf, vf = cache(B, 512)
    pos = torch.tensor(POS[:B], device="cuda")
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
    shapes = bench_decode_attention.run_kv_int8(k5_shapes)
    for r in shapes:
        print(f"  time {r['shape']} bf16 q S=512: kernel {r['ms']:.5f} ms "
              f"device (CUDA graph replay over {r['caches']} caches, "
              f"{r['mb_read_a_cycle']:.0f} MB of K/V and scales a cycle); "
              f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}, "
              f"{r['bound_ms'] / r['ms']:.1%} of it); K5 at the same "
              f"positions {r['k5_ms']:.5f} ms; reference only, not a library "
              f"call for this function: SDPA over the rows dequantized to "
              f"bf16 {r['sdpa_dequantized_reference_ms']:.5f} ms [{card}]")
    t_p = time_ms(lambda: decode_attention_kv_int8_plain(q, kq, ks, vq, vs,
                                                         pos), 2, 3)
    print(f"  plain B=4 pos {POS[:B]}: {t_p:.3f} ms per eager call [{card}]")
    b4, b8, b1 = shapes[:3]
    return {"name": "decode_attention_kv_int8", "route": "cuda",
            "source": "qwen3_tts_tpu_torch/csrc/decode_attention.cu",
            "replaces": "qwen3_tts_tpu/ops/pallas/kv_int8.py:115",
            "max_abs_err": worst, "ms": b4["ms"], "plain_ms": t_p,
            "bound_ms": b4["bound_ms"], "bound_by": b4["bound_by"],
            "library_ms": None,
            "sdpa_bf16_reference_ms": b4["sdpa_dequantized_reference_ms"],
            "k5_ms": b4["k5_ms"], "ms_b8": b8["ms"],
            "bound_ms_b8": b8["bound_ms"], "ms_b1": b1["ms"],
            "bound_ms_b1": b1["bound_ms"],
            "shape": f"{b4['shape']} Hq=16 Hkv=8 Dh=128 S=512 int8 KV, bf16 "
                     f"q", "shapes": shapes}


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
            b._free_by_group[0].reverse()  # other pages the second time
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


# ---------------------------------------------------------------------------
# Checkpoints: the inverse of io/weights.py's key mapping and a
# safetensors writer (helpers of phase_checkpoint and of the CPU tests
# tests/test_torch_weights_io.py and test_torch_checkpoint.py)
# ---------------------------------------------------------------------------

# the reference audio of phase_checkpoint: 5 s of the port's vocoder
# output for seeded codes, written at 16 kHz so that resample_linear runs
REF_SECONDS, REF_RATE = 5, 16000
_ST_NAMES = {"torch.float64": "F64", "torch.float32": "F32",
             "torch.float16": "F16", "torch.bfloat16": "BF16",
             "torch.int64": "I64", "torch.int32": "I32",
             "torch.int16": "I16", "torch.int8": "I8", "torch.uint8": "U8",
             "torch.bool": "BOOL"}


def _hf_layers(lay: dict, prefix: str) -> dict:
    """A stacked layer dict as HF's per-layer tensors ((out, in))."""
    out = {}
    for i in range(lay["input_ln"].shape[0]):
        p = f"{prefix}.{i}."
        out[p + "input_layernorm.weight"] = lay["input_ln"][i]
        out[p + "post_attention_layernorm.weight"] = lay["post_ln"][i]
        out[p + "self_attn.q_norm.weight"] = lay["q_norm"][i]
        out[p + "self_attn.k_norm.weight"] = lay["k_norm"][i]
        for n in ("q_proj", "k_proj", "v_proj", "o_proj"):
            out[p + f"self_attn.{n}.weight"] = lay[n][i].T
        for n in ("gate_proj", "up_proj", "down_proj"):
            out[p + f"mlp.{n}.weight"] = lay[n][i].T
    return out


def hf_state_dict(params: dict) -> dict:
    """The dense talker and code predictor of a port param tree under the
    HF Qwen3-TTS checkpoint's names and (out, in) layouts: the inverse of
    io/weights.load_talker_from_hf and load_code_predictor_from_hf."""
    t, c = params["talker"], params["code_predictor"]
    sd = _hf_layers(t["layers"], "talker.model.layers")
    sd.update({
        "talker.model.norm.weight": t["final_norm"],
        "talker.model.text_embedding.weight": t["text_embedding"],
        "talker.text_projection.linear_fc1.weight": t["proj_fc1_w"].T,
        "talker.text_projection.linear_fc1.bias": t["proj_fc1_b"],
        "talker.text_projection.linear_fc2.weight": t["proj_fc2_w"].T,
        "talker.text_projection.linear_fc2.bias": t["proj_fc2_b"],
        "talker.model.codec_embedding.weight": t["codec_embedding"],
        "talker.codec_head.weight": t["codec_head"].T,
    })
    pre = "talker.code_predictor"
    sd.update(_hf_layers(c["layers"], f"{pre}.model.layers"))
    sd[f"{pre}.model.norm.weight"] = c["final_norm"]
    sd[f"{pre}.small_to_mtp_projection.weight"] = c["mtp_proj_w"].T
    sd[f"{pre}.small_to_mtp_projection.bias"] = c["mtp_proj_b"]
    for g in range(c["codec_embs"].shape[0]):
        sd[f"{pre}.model.codec_embedding.{g}.weight"] = c["codec_embs"][g]
        sd[f"{pre}.lm_head.{g}.weight"] = c["lm_heads"][g].T
    return {k: v.contiguous() for k, v in sd.items()}


def _conv_sd(w):          # WIO (K, Cin/g, Cout) -> torch (Cout, Cin/g, K)
    return w.permute(2, 1, 0)


def _window_sd(p: dict, prefix: str) -> dict:
    lay, out = p["layers"], {prefix + ".norm.weight": p["norm"]}
    names = (("input_ln", "input_layernorm.weight", False),
             ("post_ln", "post_attention_layernorm.weight", False),
             ("q_proj", "self_attn.q_proj.weight", True),
             ("k_proj", "self_attn.k_proj.weight", True),
             ("v_proj", "self_attn.v_proj.weight", True),
             ("o_proj", "self_attn.o_proj.weight", True),
             ("gate_proj", "mlp.gate_proj.weight", True),
             ("up_proj", "mlp.up_proj.weight", True),
             ("down_proj", "mlp.down_proj.weight", True),
             ("attn_scale", "self_attn_layer_scale.scale", False),
             ("mlp_scale", "mlp_layer_scale.scale", False))
    for i in range(lay["input_ln"].shape[0]):
        for key, name, tr in names:
            w = lay[key][i]
            out[f"{prefix}.layers.{i}.{name}"] = w.T if tr else w
    return out


def _convnext_sd(p: dict, u: str) -> dict:
    return {u + "dwconv.conv.weight": _conv_sd(p["cn_dw_w"]),
            u + "dwconv.conv.bias": p["cn_dw_b"],
            u + "norm.weight": p["cn_ln_w"], u + "norm.bias": p["cn_ln_b"],
            u + "pwconv1.weight": p["cn_pw1_w"].T,
            u + "pwconv1.bias": p["cn_pw1_b"],
            u + "pwconv2.weight": p["cn_pw2_w"].T,
            u + "pwconv2.bias": p["cn_pw2_b"], u + "gamma": p["cn_gamma"]}


def _res_sd(p: dict, r: str) -> dict:
    return {r + "act1.alpha": p["alpha1"], r + "act1.beta": p["beta1"],
            r + "conv1.conv.weight": _conv_sd(p["conv1_w"]),
            r + "conv1.conv.bias": p["conv1_b"],
            r + "act2.alpha": p["alpha2"], r + "act2.beta": p["beta2"],
            r + "conv2.conv.weight": _conv_sd(p["conv2_w"]),
            r + "conv2.conv.bias": p["conv2_b"]}


def vocoder_state_dict(vp: dict) -> dict:
    """The vocoder tree under the speech tokenizer decoder's torch names
    (``decoder.`` stripped): the inverse of io/weights.
    load_vocoder_from_state_dict."""
    sd = {"code_embedding.weight": vp["code_embedding"],
          **_window_sd(vp["pre"], "pre_transformer")}
    for i, up in sorted(vp["upsample"].items()):
        u = f"upsample.{i}."
        sd[u + "0.conv.weight"] = up["up_w"].flip(0).permute(1, 2, 0)
        sd[u + "0.conv.bias"] = up["up_b"]
        sd.update(_convnext_sd(up, u + "1."))
    sd["decoder.0.conv.weight"] = _conv_sd(vp["dec_in_w"])
    sd["decoder.0.conv.bias"] = vp["dec_in_b"]
    n = len(vp["blocks"])
    for i in range(n):
        blk, d = vp["blocks"][str(i)], f"decoder.{i + 1}.block."
        sd[d + "0.alpha"], sd[d + "0.beta"] = blk["alpha"], blk["beta"]
        sd[d + "1.conv.weight"] = blk["up_w"].flip(0).permute(1, 2, 0)
        sd[d + "1.conv.bias"] = blk["up_b"]
        for d_i in range(3):
            sd.update(_res_sd(blk["res"][str(d_i)], d + f"{d_i + 2}."))
    sd[f"decoder.{n + 1}.alpha"] = vp["out_alpha"]
    sd[f"decoder.{n + 1}.beta"] = vp["out_beta"]
    sd[f"decoder.{n + 2}.conv.weight"] = _conv_sd(vp["out_w"])
    sd[f"decoder.{n + 2}.conv.bias"] = vp["out_b"]
    return {k: v.contiguous() for k, v in sd.items()}


def encoder_state_dict(ep: dict) -> dict:
    """The encoder tree under its mirror names (``encoder.`` stripped):
    the inverse of models/encoder.load_encoder_from_state_dict."""
    sd = {"encoder.0.conv.weight": _conv_sd(ep["enc_in_w"]),
          "encoder.0.conv.bias": ep["enc_in_b"]}
    n = len(ep["blocks"])
    for i in range(n):
        blk, d = ep["blocks"][str(i)], f"encoder.{i + 1}.block."
        for d_i in range(3):
            sd.update(_res_sd(blk["res"][str(d_i)], d + f"{d_i}."))
        sd[d + "3.alpha"], sd[d + "3.beta"] = blk["alpha"], blk["beta"]
        sd[d + "4.conv.weight"] = _conv_sd(blk["down_w"])
        sd[d + "4.conv.bias"] = blk["down_b"]
    sd[f"encoder.{n + 1}.conv.weight"] = _conv_sd(ep["enc_out_w"])
    sd[f"encoder.{n + 1}.conv.bias"] = ep["enc_out_b"]
    for i, st in sorted(ep["downsample"].items()):
        u = f"downsample.{i}."
        sd.update(_convnext_sd(st, u + "0."))
        sd[u + "1.conv.weight"] = _conv_sd(st["down_w"])
        sd[u + "1.conv.bias"] = st["down_b"]
    sd.update(_window_sd(ep["post"], "post_transformer"))
    return {k: v.contiguous() for k, v in sd.items()}


def write_safetensors(path: str, tensors: dict) -> int:
    """A .safetensors file of torch tensors (any device), in name order;
    returns its bytes."""
    import struct
    import torch
    header, off = {}, 0
    for k in sorted(tensors):
        t = tensors[k]
        n = t.numel() * t.element_size()
        header[k] = {"dtype": _ST_NAMES[str(t.dtype)],
                     "shape": list(t.shape), "data_offsets": [off, off + n]}
        off += n
    hb = json.dumps(header).encode()
    hb += b" " * (-len(hb) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hb)))
        f.write(hb)
        for k in sorted(tensors):
            t = tensors[k].detach().contiguous().cpu().reshape(-1)
            f.write(memoryview(t.view(torch.uint8).numpy()))
    return os.path.getsize(path)


def write_checkpoint(d: str, params: dict, enc_params: dict) -> dict:
    """An HF-named checkpoint directory from a dense port param tree and
    an encoder tree: ``model.safetensors`` (talker and code predictor, in
    their dtype) and ``speech_tokenizer/model.safetensors`` (``decoder.*``
    and ``encoder.*``, f32). Returns each file's bytes."""
    os.makedirs(os.path.join(d, "speech_tokenizer"), exist_ok=True)
    st = {"decoder." + k: v
          for k, v in vocoder_state_dict(params["vocoder"]).items()}
    st.update({"encoder." + k: v
               for k, v in encoder_state_dict(enc_params).items()})
    return {
        "model.safetensors": write_safetensors(
            os.path.join(d, "model.safetensors"), hf_state_dict(params)),
        "speech_tokenizer/model.safetensors": write_safetensors(
            os.path.join(d, "speech_tokenizer", "model.safetensors"), st),
    }


def _rvq_flips(got, want, z, codebooks) -> int:
    """Frames whose codes differ between two RVQ runs (``got`` against
    ``want``, (T, 16)) may differ only from a near tie: at the first stage
    where they part, the squared distances of the two rows from ``want``'s
    residual (float64, from latent z (T, H) and codebooks (16, V, H)) lie
    within 1e-5 relative. Returns the count of such frames; fails on any
    other difference."""
    import numpy as np
    check(got.shape == want.shape, f"RVQ codes {got.shape} {want.shape}")
    z = np.asarray(z, np.float64)
    cb = np.asarray(codebooks, np.float64)
    flips = 0
    for t in np.nonzero((got != want).any(axis=1))[0]:
        q = int(np.nonzero(got[t] != want[t])[0][0])
        r = z[t] * cb.shape[0] - sum(cb[s, want[t, s]] for s in range(q))
        da = float(((r - cb[q, want[t, q]]) ** 2).sum())
        db = float(((r - cb[q, got[t, q]]) ** 2).sum())
        check(abs(da - db) <= 1e-5 * max(da, db),
              f"RVQ frame {t} stage {q}: codes {want[t, q]} / {got[t, q]} "
              f"at distances {da} / {db}, no near tie")
        flips += 1
    return flips


def phase_checkpoint(eng, params, card: str, counters: dict) -> dict:
    """Checkpoint loading and the reference encoder at full geometry,
    before any profiler session:

    1. eng's seed-0 weights (``params``, before quantization) and a seeded
       encoder written as an HF checkpoint directory;
    2. detect_tts_config equal to TTSConfig()'s talker and code
       predictor; TTSEngine(model_dir=d, quantize="int8") gives eng's
       codes and int16 audio bit for bit on TEXTS, launching K1 (both
       routes), K2 and K3;
    3. convert_weights --quantize int8 to a params.npz, whose engine
       reports "int8" and gives eng's codes;
    4. encode_reference_audio on 5 s of audio at 16 kHz, on the card and
       with --device cpu: latents within 1e-4 of their scale, codes equal
       but for counted near ties; the encoder's ms; the loaded engine's
       cloned request (the tile at the cloned R) equal to eng's;
    5. the CLI with --model_dir d --quantize int8 writes a WAV.

    Returns the kernels' launches on the loaded engine's requests."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from qwen3_tts_tpu_torch import cli
    from qwen3_tts_tpu_torch.config import SAMPLE_RATE, TTSConfig
    from qwen3_tts_tpu_torch.engine.engine import TTSEngine
    from qwen3_tts_tpu_torch.io import wav as wav_io
    from qwen3_tts_tpu_torch.io import weights as weights_io
    from qwen3_tts_tpu_torch.models import encoder as enc
    from qwen3_tts_tpu_torch.models import talker as tk
    from qwen3_tts_tpu_torch.models import vocoder as voc
    from qwen3_tts_tpu_torch.tools import convert_weights
    from qwen3_tts_tpu_torch.tools import encode_reference_audio
    t_phase = time.perf_counter()
    cfg = TTSConfig()
    L = cfg.talker.num_layers
    root = tempfile.mkdtemp(prefix="q3ckpt_")
    try:
        # 1. the checkpoint
        d = os.path.join(root, "hf")
        enc_params = enc.init_encoder_params(cfg.encoder, seed=0,
                                             device="cuda")
        t0 = time.perf_counter()
        sizes = write_checkpoint(d, params, enc_params)
        print(f"checkpoint written: {sizes} bytes in "
              f"{time.perf_counter() - t0:.2f} s [{card}]")

        # 2. load it: the int8 engine gives eng's codes and audio
        det = weights_io.detect_tts_config(d)
        check(det.talker == cfg.talker
              and det.code_predictor == cfg.code_predictor,
              f"detect_tts_config: {det}")
        want = []
        for i, text in enumerate(TEXTS):
            eng._prefix_cache.clear()
            want.append(eng.synthesize(text, seed=i))
        t0 = time.perf_counter()
        loaded = TTSEngine(model_dir=d, quantize="int8", device="cuda")
        torch.cuda.synchronize()
        t_st = time.perf_counter() - t0
        check(loaded.cfg == cfg, f"the loaded engine's config {loaded.cfg}")
        print(f"TTSEngine(model_dir, quantize='int8'): {t_st:.2f} s, of "
              f"which { {k: round(v, 3) for k, v in loaded.load_seconds.items()} } "
              f"s; tokenizer {type(loaded.tokenizer).__name__} [{card}]")
        for fn in counters.values():
            fn.launches = 0
        for i, text in enumerate(TEXTS):
            res = loaded.synthesize(text, seed=i)
            _check_result(res, f"loaded request {i}")
            check(np.array_equal(res.codes, want[i].codes)
                  and np.array_equal(res.audio_int16, want[i].audio_int16),
                  f"loaded request {i}: other codes or audio than eng's")
        torch.cuda.synchronize()
        launches = _launches(counters)
        for k in ("qmatmul", "qmatmul_qsplit", "qmatmul_tile", "talker_step",
                  "cp_decode"):
            check(launches[k] > 0, f"loaded engine: {k} not launched")
        print(f"loaded engine: {len(TEXTS)} requests ("
              f"{[r.n_tokens for r in want]} tokens) equal to eng's in "
              f"codes and int16 audio; launches "
              f"{ {k: v for k, v in launches.items() if v} } [{card}]")

        # 3. a pre-quantized params.npz
        d2 = os.path.join(root, "npz")
        os.makedirs(d2)
        npz = os.path.join(d2, "params.npz")
        t0 = time.perf_counter()
        rc = convert_weights.main(["--model_dir", d, "--quantize", "int8",
                                   "--output", npz])
        t_conv = time.perf_counter() - t0
        check(rc == 0, f"convert_weights: exit {rc}")
        t0 = time.perf_counter()
        pre = TTSEngine(model_dir=d2, device="cuda")
        torch.cuda.synchronize()
        t_npz = time.perf_counter() - t0
        check(pre.quantize == "int8" and pre.cfg == cfg,
              f"params.npz engine: quantize {pre.quantize!r}")
        for i, text in enumerate(TEXTS):
            res = pre.synthesize(text, seed=i)
            check(np.array_equal(res.codes, want[i].codes),
                  f"params.npz request {i}: other codes than eng's")
        print(f"convert_weights --quantize int8: {os.path.getsize(npz)} "
              f"bytes in {t_conv:.2f} s; TTSEngine(model_dir=params.npz "
              f"dir): {t_npz:.2f} s ("
              f"{ {k: round(v, 3) for k, v in pre.load_seconds.items()} }) "
              f"against {t_st:.2f} s from safetensors; quantize "
              f"{pre.quantize!r}, codes equal to eng's [{card}]")
        del pre

        # 4. encode a reference, on the card and on the host
        frames = np.random.default_rng(11).integers(
            0, 2048, (-(-REF_SECONDS * SAMPLE_RATE // 1920), 16))
        audio = eng.vocode(frames)[:REF_SECONDS * SAMPLE_RATE]
        ref16 = enc.resample_linear(audio.astype(np.float32) / 32768.0,
                                    SAMPLE_RATE, REF_RATE)
        ref_wav = os.path.join(root, "ref.wav")
        wav_io.write_wav(ref_wav, voc.to_int16(ref16), REF_RATE)
        prompts, secs = {}, {}
        for dev in ("cuda", "cpu"):
            prompts[dev] = os.path.join(root, f"prompt_{dev}")
            t0 = time.perf_counter()
            rc = encode_reference_audio.main(
                ["--audio", ref_wav, "--model_dir", d, "--output_dir",
                 prompts[dev], "--ref_text", CLONE_TEXT, "--device", dev])
            secs[dev] = time.perf_counter() - t0
            check(rc == 0, f"encode_reference_audio --device {dev}: {rc}")
        codes = {dev: np.load(os.path.join(p, "ref_codec_tokens.npy"))
                 for dev, p in prompts.items()}
        check(codes["cuda"].dtype == np.int64
              and codes["cuda"].shape == (len(frames), 16),
              f"prompt tokens {codes['cuda'].dtype} {codes['cuda'].shape}")
        wav24 = enc.pad_to_tokens(enc.resample_linear(
            *wav_io.read_wav(ref_wav), SAMPLE_RATE))
        st = weights_io.load_speech_tokenizer(
            os.path.join(d, "speech_tokenizer"), cfg)
        x = torch.from_numpy(wav24)[None]
        with torch.inference_mode():
            z_cpu = enc.encode_features(st["encoder"], x, cfg.encoder)[0]
            st = weights_io.to_device(st, "cuda")
            xc = x.cuda()
            z_card = enc.encode_features(st["encoder"], xc,
                                         cfg.encoder)[0].cpu()
        scale = float(z_cpu.abs().max())
        err = float((z_card - z_cpu).abs().max())
        check(err <= 1e-4 * scale, f"encoder latents: card against CPU "
              f"max|diff| {err} of scale {scale}")
        cb = enc.decoder_codebooks(st["vocoder"], cfg.vocoder)
        flips = _rvq_flips(codes["cuda"], codes["cpu"], z_cpu.numpy(),
                           cb.cpu().numpy())
        with torch.inference_mode():
            ms = time_ms(lambda: enc.encode(st["encoder"], cb, xc,
                                            cfg.encoder), iters=5, reps=3)
            ms_feat = time_ms(lambda: enc.encode_features(
                st["encoder"], xc, cfg.encoder), iters=5, reps=3)
        print(f"encoder: {REF_SECONDS} s at {REF_RATE} Hz -> "
              f"{len(frames)} tokens; latents card against CPU max|diff| "
              f"{err:.3e} (scale {scale:.3e}); codes card against CPU: "
              f"{flips} near-tie flips; encode {ms:.3f} ms (features "
              f"{ms_feat:.3f}, RVQ {ms - ms_feat:.3f}); the tool "
              f"{secs['cuda']:.2f} s on the card, {secs['cpu']:.2f} s on "
              f"the host's CPU [{card}]")
        del st

        # the loaded engine clones from the encoded prompt dir
        ref_codes, ref_text = loaded._load_prompt(prompts["cuda"])
        ids, _, _ = loaded._encode_cloned(TEXTS[0], ref_text)
        padded, _ = tk.bucket_ref_frames(
            tk.cloned_ref_limit(cfg.talker.max_seq_len, len(ids)), ref_codes)
        R = len(ids) + tk.PREFIX_EXTRA + len(padded)
        loaded._prefix_cache.clear()
        before = _launches(counters)
        res = loaded.synthesize(TEXTS[0], seed=0, prompt_dir=prompts["cuda"])
        torch.cuda.synchronize()
        grew = _grew(before, counters)
        for k, v in grew.items():
            launches[k] += v
        _check_result(res, "cloned request (loaded)")
        check(grew["qmatmul_tile"] == 4 * L,
              f"cloned request: the tile launched {grew['qmatmul_tile']}")
        eng._prefix_cache.clear()
        same = eng.synthesize(TEXTS[0], seed=0, prompt_dir=prompts["cuda"])
        check(np.array_equal(res.codes, same.codes),
              "cloned request: the loaded engine's codes are not eng's")
        print(f"cloned from the encoded prompt dir: R={R} rows, the tile "
              f"{grew['qmatmul_tile']} launches, n_tokens {res.n_tokens}, "
              f"codes equal to eng's [{card}]")
        del loaded

        # 5. the command line
        out = os.path.join(root, "cli.wav")
        t0 = time.perf_counter()
        rc = cli.main([TEXTS[1], "--model_dir", d, "--quantize", "int8",
                       "--output", out])
        check(rc == 0 and os.path.getsize(out) > 44,
              f"cli --model_dir: exit {rc}")
        print(f"cli --model_dir --quantize int8: exit 0, WAV "
              f"{os.path.getsize(out)} bytes, "
              f"{time.perf_counter() - t0:.1f} s with the load [{card}]")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"checkpoint phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


# the serving phase's long request: two sentence pieces under the byte
# tokenizer's piece budget of 33 tokens
SERVE_LONG = "Привет! Hello there, this is the port."
# the batched daemon's runs: depth 1 and 2 in turns, two each
SERVE_DEPTHS = (1, 2, 2, 1)
SERVE_STREAMING = (1, 4)
SERVE_MAX_TOKENS = 48


def _wait_socket(path: str) -> None:
    deadline = time.time() + 60
    while not os.path.exists(path):
        check(time.time() < deadline, f"serving: {path} never appeared")
        time.sleep(0.02)


def _serve_engine_daemon(eng, root: str, card: str) -> None:
    """The int8 engine's daemon on the native accept loop, with a voice
    registry and the HTTP gateway: blobs, a stream, a long request and a
    voice by name, each against eng's own synthesis."""
    import http.client
    import threading
    import numpy as np
    from qwen3_tts_tpu_torch.runtime import native
    from qwen3_tts_tpu_torch.serve import daemon as dm
    from qwen3_tts_tpu_torch.serve.http import serve_http
    from qwen3_tts_tpu_torch.serve.voices import VoiceRegistry
    check(native.available(), "serving: libttsrt did not build (g++ on "
          "native/ttsrt.cc), so the daemon would fall back to the Python "
          "accept loop")
    voice_dir = os.path.join(root, "voices", "clone")
    os.makedirs(voice_dir)
    np.save(os.path.join(voice_dir, "ref_codec_tokens.npy"),
            np.random.default_rng(7).integers(
                0, 2048, (CLONE_FRAMES, 16)).astype(np.int64))
    with open(os.path.join(voice_dir, "ref_text.txt"), "w") as f:
        f.write(CLONE_TEXT)
    reg = VoiceRegistry(os.path.join(root, "voices"))
    check(reg.names() == ["clone"], f"serving: registry {reg.names()}")
    sock = os.path.join(root, "engine.sock")
    daemon = dm.TTSDaemon(eng, sock, voices=reg)
    native_calls = []
    real_serve_unix = native.serve_unix

    def counted_serve_unix(*a, **k):
        native_calls.append(a[0])
        return real_serve_unix(*a, **k)

    native.serve_unix = counted_serve_unix
    t = threading.Thread(target=daemon.serve, daemon=True)
    t.start()
    srv = None
    try:
        _wait_socket(sock)
        check(native_calls == [sock], "serving: the engine daemon is not "
              "on the native accept loop")
        client = dm.DaemonClient(sock)
        blobs = {}
        for i, text in enumerate(TEXTS):
            eng._prefix_cache.clear()
            t0 = time.perf_counter()
            hdr, audio = client.synthesize(text, seed=i)
            wall = time.perf_counter() - t0
            want = eng.synthesize(text, seed=i)
            check(hdr["n_tokens"] == want.n_tokens > 0,
                  f"engine daemon blob {i}: n_tokens {hdr['n_tokens']} "
                  f"!= {want.n_tokens}")
            check(np.array_equal(audio, want.audio_int16),
                  f"engine daemon blob {i}: audio differs from "
                  "eng.synthesize")
            blobs[i] = audio
            print(f"engine daemon blob {i}: n_tokens={hdr['n_tokens']} "
                  f"{len(audio) * 2} bytes of int16, client wall "
                  f"{wall:.4f} s, engine total {hdr['total_seconds']:.4f} s "
                  f"(framing and socket {(wall - hdr['total_seconds']) * 1e3:.2f}"
                  f" ms), {wall / hdr['n_tokens'] * 1e3:.2f} ms/token; "
                  f"equal to eng.synthesize bit for bit [{card}]")
        # a chunked stream
        frames, first = [], []
        t0 = time.perf_counter()

        def on_frame(h, a):
            if "chunk" in h:
                if not first:
                    first.append(time.perf_counter() - t0)
                frames.append(a)

        hdr, audio = client.synthesize(TEXTS[1], seed=1, stream=True,
                                       on_chunk=on_frame)
        wall = time.perf_counter() - t0
        pieces = []
        want = eng.synthesize(TEXTS[1], seed=1, streaming=True,
                              on_chunk=pieces.append)
        check(np.array_equal(np.concatenate(frames), audio),
              "engine daemon stream: the frames are not its audio")
        check(np.array_equal(audio, want.audio_int16),
              "engine daemon stream: audio differs from eng's stream")
        check(len(frames) == len(pieces), "engine daemon stream: "
              f"{len(frames)} frames for {len(pieces)} engine pieces")
        dmax, share = int16_delta(audio, blobs[1])
        check(dmax <= 1, f"engine daemon stream: {dmax} LSB off the blob")
        print(f"engine daemon stream: {len(frames)} frames, n_tokens "
              f"{hdr['n_tokens']}, first frame {first[0]:.4f} s after the "
              f"request (engine first_audio_seconds "
              f"{hdr['first_audio_seconds']:.4f}), wall {wall:.4f} s; equal "
              f"to eng's stream bit for bit, int16 max|diff| {dmax} against "
              f"the blob [{card}]")
        # a long request and a voice by name
        hdr, audio = client.synthesize(SERVE_LONG, seed=5, long=True)
        want = eng.synthesize_long(SERVE_LONG, seed=5)
        check(hdr["n_tokens"] == want.n_tokens and np.array_equal(
            audio, want.audio_int16), "engine daemon long: differs from "
            "eng.synthesize_long")
        hdr_v, audio_v = client.synthesize(TEXTS[2], seed=2, voice="clone")
        want_v = eng.synthesize(TEXTS[2], seed=2, prompt_dir=voice_dir)
        check(np.array_equal(audio_v, want_v.audio_int16),
              "engine daemon voice: differs from the prompt dir request")
        check(not np.array_equal(audio_v, blobs[2]),
              "engine daemon voice: the voice changed nothing")
        print(f"engine daemon long: {hdr['n_tokens']} tokens; voice "
              f"'clone': {hdr_v['n_tokens']} tokens; both equal to eng bit "
              f"for bit [{card}]")
        # the same daemon over HTTP
        srv = serve_http(daemon, port=0)
        c = http.client.HTTPConnection(*srv.server_address, timeout=300)
        c.request("POST", "/v1/audio/speech", body=json.dumps(
            {"input": TEXTS[0], "seed": 0}).encode())
        r = c.getresponse()
        body = r.read()
        check(r.status == 200, f"HTTP speech: status {r.status}")
        import io
        import wave
        with wave.open(io.BytesIO(body), "r") as wf:
            got = np.frombuffer(wf.readframes(wf.getnframes()), np.int16)
        check(np.array_equal(got, blobs[0]),
              "HTTP speech: the WAV's samples differ from the blob")
        c.request("GET", "/metrics")
        r = c.getresponse()
        metrics = dict(line.rsplit(" ", 1) for line in
                       r.read().decode().strip().split("\n"))
        c.close()
        check(r.status == 200 and float(metrics["qwen3_tts_requests_total"])
              >= 6, "HTTP metrics")
        print(f"HTTP gateway: /v1/audio/speech wav equal to the blob; "
              f"/metrics {len(metrics)} series, requests_total "
              f"{metrics['qwen3_tts_requests_total']}, errors_total "
              f"{metrics['qwen3_tts_errors_total']} [{card}]")
    finally:
        if srv is not None:
            srv.shutdown()
        daemon.stop()
        t.join(timeout=30)
        native.serve_unix = real_serve_unix
    check(not t.is_alive(), "engine daemon: did not stop")


def _batched_run(sock: str) -> dict:
    """Six concurrent clients (two streaming) on a batched daemon: their
    audio, walls, first frames and the run's wall."""
    import threading
    import numpy as np
    from qwen3_tts_tpu_torch.serve.daemon import DaemonClient
    out, errors = {}, []

    def call(i):
        t0 = time.perf_counter()
        first = []

        def on_frame(h, a):
            if "chunk" in h and not first:
                first.append(time.perf_counter() - t0)
        try:
            hdr, audio = DaemonClient(sock).synthesize(
                BATCH_TEXTS[i], seed=i, max_tokens=SERVE_MAX_TOKENS,
                stream=i in SERVE_STREAMING, on_chunk=on_frame)
            out[i] = (hdr, audio, time.perf_counter() - t0,
                      first[0] if first else None)
        except Exception as e:     # reported below, on the main thread
            errors.append((i, e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(BATCH_TEXTS))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t0
    check(not errors, f"batched daemon clients failed: {errors}")
    check(sorted(out) == list(range(len(BATCH_TEXTS))),
          "batched daemon: a client did not finish")
    audio_s = sum(len(o[1]) for o in out.values()) / 24000
    return {"audio": {i: o[1] for i, o in out.items()}, "wall": wall,
            "audio_s": audio_s,
            "req_walls": [o[2] for o in out.values()],
            "first": [out[i][3] for i in SERVE_STREAMING],
            "n_tokens": {i: o[0]["n_tokens"] for i, o in out.items()}}


def _serve_batched(eng, params, root: str, card: str,
                   counters: dict) -> dict:
    """The batched daemon over the bf16 batcher (4 slots, decode_chunk
    32), dense (K5) then paged (K4), at pipeline_depth 1 and 2 in turns:
    every run's audio equal to the first depth-1 run's; audio-s per
    wall-s, request wall p50 and the streaming clients' first frame p50
    and p95 per depth. Returns the attention kernels' launches."""
    import threading
    import numpy as np
    from qwen3_tts_tpu_torch.config import TalkerConfig, TTSConfig
    from qwen3_tts_tpu_torch.serve import daemon as dm
    from qwen3_tts_tpu_torch.serve.batching import ContinuousBatcher
    cfg = TTSConfig(talker=TalkerConfig(attention_impl="pallas"))
    att = {}
    for paged in (False, True):
        label = "paged" if paged else "dense"
        kw = dict(paged=True, page_size=64) if paged else {}
        daemons = {}
        for depth in (1, 2):
            b = ContinuousBatcher(cfg, params, batch_size=4, decode_chunk=32,
                                  pipeline_depth=depth, device="cuda", **kw)
            d = dm.TTSDaemon(eng, os.path.join(root, f"{label}{depth}.sock"),
                             batcher=b)
            t = threading.Thread(target=d.serve, daemon=True)
            t.start()
            _wait_socket(d.socket_path)
            daemons[depth] = (d, t)
        kname = "paged_attention" if paged else "decode_attention"
        before = counters[kname].launches
        runs = {1: [], 2: []}
        ref = None
        try:
            for d, _ in daemons.values():     # warm-up, prefix LRUs too
                _batched_run(d.socket_path)
            for depth in SERVE_DEPTHS:
                r = _batched_run(daemons[depth][0].socket_path)
                if ref is None:
                    ref = r
                for i in range(len(BATCH_TEXTS)):
                    check(np.array_equal(r["audio"][i], ref["audio"][i]),
                          f"batched daemon {label} depth {depth}: request "
                          f"{i}'s audio differs from depth 1's")
                runs[depth].append(r)
        finally:
            for d, t in daemons.values():
                d.stop()
                t.join(timeout=60)
        att[kname] = counters[kname].launches - before
        check(att[kname] > 0, f"batched daemon {label}: {kname} was not "
              "launched")
        for depth in (1, 2):
            rs = runs[depth]
            rate = [r["audio_s"] / r["wall"] for r in rs]
            walls = np.concatenate([r["req_walls"] for r in rs])
            first = np.array([f for r in rs for f in r["first"]])
            print(f"batched daemon {label} depth {depth}: audio-s per "
                  f"wall-s {' '.join(f'{x:.4f}' for x in rate)} (runs in "
                  f"turns), request wall p50 {np.percentile(walls, 50):.4f}"
                  f" s, streaming first frame p50 "
                  f"{np.percentile(first, 50):.4f} s p95 "
                  f"{np.percentile(first, 95):.4f} s ({len(first)} "
                  f"frames), tokens {sorted(rs[0]['n_tokens'].items())} [{card}]")
        print(f"batched daemon {label}: every run's audio equal to the "
              f"first depth-1 run's, bit for bit ({len(SERVE_DEPTHS)} "
              f"timed runs) [{card}]")
    return att


def _serve_compat(eng, root: str, card: str, counters: dict) -> None:
    """The compat stack over the int8 engine's weights: the port's
    reference client synthesizes one text through the three sockets;
    codes in range, n_tokens x 1920 samples, K3 and K2 launched."""
    import numpy as np
    from qwen3_tts_tpu_torch.serve import compat
    from qwen3_tts_tpu_torch.tools.reference_client import reference_flow
    socks = tuple(os.path.join(root, f"{n}.sock")
                  for n in ("talker", "cp", "voc"))
    servers, threads = compat.launch_all(eng.params, eng.cfg, eng.tokenizer,
                                         *socks, device="cuda")
    before = _launches(counters)
    try:
        for s in socks:
            _wait_socket(s)
        t0 = time.perf_counter()
        codes, audio = reference_flow(TEXTS[0], "russian", eng.params,
                                      *socks, log=lambda m: None)
        wall = time.perf_counter() - t0
    finally:
        for s in servers:
            s.stop()
        for t in threads:
            t.join(timeout=30)
    grew = _grew(before, counters)
    n = len(codes)
    check(n > 0, "compat: no tokens")
    check(bool(((codes >= 0) & (codes < 2048)).all()),
          "compat: codes out of [0, 2048)")
    check(len(audio) == n * 1920, f"compat: {len(audio)} samples for {n} "
          "tokens")
    for k in ("talker_step", "cp_decode", "qmatmul"):
        check(grew[k] > 0, f"compat: {k} was not launched")
    print(f"compat stack: {n} tokens through the three sockets in "
          f"{wall:.3f} s ({wall / n * 1e3:.2f} ms/token), {len(audio)} "
          f"samples; launches K3 {grew['talker_step']} K2 "
          f"{grew['cp_decode']} K1 {grew['qmatmul']} [{card}]")


def phase_serving(eng, params, card: str, counters: dict) -> dict:
    """The serving tier at full geometry, before any profiler session:
    the int8 engine's daemon on the native loop (and over HTTP), the
    bf16 batched daemon at pipeline_depth 1 and 2, and the compat stack.
    Returns K1-K5's launches in the phase."""
    import shutil
    import tempfile
    t_phase = time.perf_counter()
    for fn in counters.values():
        fn.launches = 0
    root = tempfile.mkdtemp(prefix="q3serve_")
    try:
        _serve_engine_daemon(eng, root, card)
        att = _serve_batched(eng, params, root, card, counters)
        _serve_compat(eng, root, card, counters)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = _launches(counters)
    for k in ("qmatmul", "talker_step", "cp_decode", "decode_attention",
              "paged_attention"):
        check(launches[k] > 0, f"serving: {k} was not launched")
    print(f"serving phase: {time.perf_counter() - t_phase:.1f} s; launches "
          f"K1 {launches['qmatmul']} (qsplit {launches['qmatmul_qsplit']}, "
          f"tile {launches['qmatmul_tile']}) K2 {launches['cp_decode']} K3 "
          f"{launches['talker_step']} K5 {att['decode_attention']} K4 "
          f"{att['paged_attention']} [{card}]")
    return launches


# ---------------------------------------------------------------------------
# phase_mesh: the dp x tp tier (parallel/), every rank a subprocess
# ---------------------------------------------------------------------------

# tokens a request of the mesh phase may take, so that the phase stays
# near two minutes: leg a's engines and batchers take 16, leg b's batchers
# phase_batcher's 48, leg c 4 (its two ranks on one card run every tp
# collective through gloo and the host, ~1.1 s a token)
MESH_TOKENS = 16
MESH_TP_TOKENS = 4
MESH_STREAMING = (1, 4)
MESH_TP_TEXTS = 3          # requests of leg c's paged batcher
MESH_RANK_TIMEOUT = 300


def _tp_mesh_of(tp: int, rank: int):
    """A layout-only (1, tp) mesh on cuda:0 seen from ``rank``: what
    parallel/mesh.shard_params cuts for that rank (no process group)."""
    import numpy as np
    from qwen3_tts_tpu_torch.parallel import mesh as pmesh
    grid = np.empty((1, tp), dtype=object)
    for r in range(tp):
        grid[0, r] = pmesh.RankDevice(r, "cuda:0")
    return pmesh.Mesh(grid, rank)


def phase_tp_kernels(params, card: str) -> dict:
    """K5, K4 and K1 at the shapes one rank of a tp mesh gives them (the
    shapes phase_mesh's leg c runs), each against its plain version on
    the same inputs, error 0 (the plain versions add up in the kernels'
    order). K5 on the talker's heads split over tp = 2 and 4 (Hq 8 / Hkv
    4, Hq 4 / Hkv 2, Dh 128) at the engine's row (B 1) and the batcher's
    (B 4) positions, S 512 (the talker) and 16 (the code predictor), f32
    and bf16. K4 at the same heads over a dp group's sub-pool (pages of
    64, B 2 and 4, the batcher's positions), also against K5 over the
    rows its table gathers. K1 on every int8 weight of the code
    predictor's tp = 2 and 4 shards, each rank's as parallel/mesh.
    shard_params cuts it from the random full-geometry weights, q|k|v and
    gate|up grouped as the per-step path launches them, at M = 1, 2, 4
    and 8 (a decode row, the 2-token prefill of one row, four decode
    rows, the prefill of four): every case on qsplit. Returns the worst
    error by kernel name."""
    import torch
    from qwen3_tts_tpu_torch.ops import quant
    from qwen3_tts_tpu_torch.ops.kernels import qmatmul as tqm
    from qwen3_tts_tpu_torch.ops.kernels.decode_attention import (
        decode_attention_cuda, decode_attention_plain)
    from qwen3_tts_tpu_torch.ops.kernels.paged_attention import (
        paged_attention_cuda, paged_attention_plain, paged_gather_kv)
    from qwen3_tts_tpu_torch.parallel import mesh as pmesh
    from qwen3_tts_tpu_torch.tools import bench_decode_attention as bda
    g = torch.Generator(device="cuda").manual_seed(11)
    worst = {"decode_attention": 0.0, "paged_attention": 0.0,
             "qmatmul": 0.0}
    k5_cases = ((512, 1, [37]), (512, 4, [0, 511, 200, 37]),
                (512, 4, [20, 27, 33, 40]), (16, 1, [2]),
                (16, 4, [2, 7, 15, 9]))
    k4_cases = ((2, [575, 64]), (4, [0, 575, 300, 64]))
    psz, MAXP = bda.PSZ, bda.MAXP
    for tp in (2, 4):
        Hq, Hkv = 16 // tp, 8 // tp
        n5 = n4 = 0
        for dtype in (torch.float32, torch.bfloat16):
            for S, B, pl in k5_cases:
                q, k, v = _attn_inputs(g, B, S, dtype, Hq, Hkv)
                pos = torch.tensor(pl, device="cuda")
                got = decode_attention_cuda(q, k, v, pos)
                err, _ = _rel_err(got, decode_attention_plain(q, k, v, pos))
                check(got.dtype == dtype and err == 0,
                      f"K5 at tp={tp} (Hq {Hq}, Hkv {Hkv}) {dtype} S={S} "
                      f"B={B} disagrees with its plain version ({err})")
                worst["decode_attention"] = max(worst["decode_attention"],
                                                err)
                n5 += 1
            for B, pl in k4_cases:
                P = B * MAXP + 1
                perm = torch.randperm(
                    P - 1, generator=torch.Generator().manual_seed(B + tp))
                table = (perm[:B * MAXP] + 1).reshape(B, MAXP).to(
                    torch.int32).cuda()
                pos = torch.tensor(pl, dtype=torch.int32, device="cuda")
                q = torch.randn((B, Hq, 128), generator=g,
                                device="cuda").to(dtype)
                pool = torch.randn((2, P, psz, Hkv, 128), generator=g,
                                   device="cuda").to(dtype)
                got = paged_attention_cuda(q, pool[0], pool[1], table, pos)
                kv = paged_gather_kv(pool, table)
                err = max(_rel_err(got, paged_attention_plain(
                    q, pool[0], pool[1], table, pos))[0],
                    _rel_err(got, decode_attention_cuda(
                        q, kv[0].contiguous(), kv[1].contiguous(),
                        pos))[0])
                check(got.dtype == dtype and err == 0,
                      f"K4 at tp={tp} (Hq {Hq}, Hkv {Hkv}) {dtype} B={B} "
                      f"disagrees with its plain version or K5 ({err})")
                worst["paged_attention"] = max(worst["paged_attention"],
                                               err)
                n4 += 1
        print(f"K5 decode_attention and K4 paged_attention at tp={tp} (Hq "
              f"{Hq}, Hkv {Hkv}, Dh 128): {n5} K5 cases (S 512 and 16, B 1 "
              f"and 4) and {n4} K4 cases (pages of {psz}, B 2 and 4), f32 "
              f"and bf16, max_abs_err 0 against the plain versions")

    cpq = quant.quantize_code_predictor(params["code_predictor"])
    groups = (("q|k|v", ("q_proj", "k_proj", "v_proj")),
              ("gate|up", ("gate_proj", "up_proj")), ("o", ("o_proj",)),
              ("down", ("down_proj",)))
    for tp in (2, 4):
        shapes, n = {}, 0
        for r in range(tp):
            cp = pmesh.shard_params(_tp_mesh_of(tp, r),
                                    {"code_predictor": cpq})["code_predictor"]
            lay, heads = cp["layers"], cp["lm_heads"]
            cases = [(f"layer {li} {name}",
                      [(lay[w].q[li], lay[w].scale[li]) for w in names])
                     for li in range(lay["q_proj"].q.shape[0])
                     for name, names in groups]
            cases += [(f"lm_head {i}", [(heads.q[i], heads.scale[i])])
                      for i in range(heads.q.shape[0])]
            for label, ws in cases:
                K = ws[0][0].shape[0]
                shapes[label.split(" ", 2)[-1] if label.startswith("layer")
                       else "lm_head"] = (K, [q.shape[1] for q, _ in ws])
                for M in (1, 2, 4, 8):
                    x = torch.randn((M, K), generator=g,
                                    device="cuda").to(torch.bfloat16)
                    check(tqm.on_qsplit(M, K, [q.shape[1] for q, _ in ws]),
                          f"K1 tp={tp} {label} M={M} is off qsplit")
                    outs = tqm.qmatmul_group(x, ws)
                    err = max(float((o - tqm.qmatmul_plain(x, q, s))
                                    .abs().max())
                              for o, (q, s) in zip(outs, ws))
                    check(err == 0, f"K1 tp={tp} rank {r} {label} M={M} "
                          f"disagrees with its plain version ({err})")
                    worst["qmatmul"] = max(worst["qmatmul"], err)
                    n += 1
            del cp
        print(f"K1 qmatmul on the code predictor's tp={tp} shards of "
              f"every rank, (K, [N]) {shapes}: {n} cases at M 1, 2, 4, 8 on "
              "qsplit, max_abs_err 0 against the plain version")
    del cpq
    print(f"tp shapes: worst errors {worst} [{card}]")
    return worst


def launch_counters() -> dict:
    """The launch-counted wrappers of K1-K7 by name."""
    from qwen3_tts_tpu_torch.ops.kernels.cp_decode import cp_decode_steps
    from qwen3_tts_tpu_torch.ops.kernels.decode_attention import (
        decode_attention)
    from qwen3_tts_tpu_torch.ops.kernels.kv_int8 import (
        decode_attention_kv_int8)
    from qwen3_tts_tpu_torch.ops.kernels.paged_attention import (
        paged_decode_attention)
    from qwen3_tts_tpu_torch.ops.kernels.qmatmul import (
        qmatmul, qmatmul_qsplit, qmatmul_tile)
    from qwen3_tts_tpu_torch.ops.kernels.talker_merged import (
        talker_decode_step_merged, talker_decode_step_mergedvec)
    from qwen3_tts_tpu_torch.ops.kernels.talker_step import (
        talker_decode_step_fused)
    return {"qmatmul": qmatmul, "qmatmul_qsplit": qmatmul_qsplit,
            "qmatmul_tile": qmatmul_tile,
            "talker_step": talker_decode_step_fused,
            "cp_decode": cp_decode_steps,
            "decode_attention": decode_attention,
            "paged_attention": paged_decode_attention,
            "decode_attention_kv_int8": decode_attention_kv_int8,
            "talker_step_merged": talker_decode_step_merged,
            "talker_step_mergedvec": talker_decode_step_mergedvec}


def _mesh_serve(b, texts, max_tokens: int, streaming=()) -> dict:
    """Serve ``texts`` through batcher b in lockstep (step() driven);
    returns {i: (codes, audio, segments)} of the requests this rank
    served, the scheduler steps and the wall seconds."""
    import numpy as np
    import torch
    from qwen3_tts_tpu_torch.tools import bench_e2e
    pieces = {i: [] for i in streaming}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    futs = [b.submit(*bench_e2e.encode_text(t), seed=i,
                     max_tokens=max_tokens,
                     on_chunk=pieces[i].append if i in pieces else None)
            for i, t in enumerate(texts)]
    steps = 0
    while not all(f.done() for f in futs):
        check(steps < 400, "mesh batcher: requests not done after 400 "
              "steps")
        b.step()
        steps += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    served = {}
    for i, f in enumerate(futs):
        codes, audio = f.result(timeout=0)
        if codes is not None:
            seg = (np.concatenate(pieces[i]) if pieces.get(i)
                   else np.zeros((0,), np.int16))
            served[i] = (codes, audio, seg)
    return {"served": served, "steps": steps, "wall": wall}


def _mesh_leg_a(mesh, counters: dict) -> dict:
    """One-rank mesh in an NCCL world of one: the int8-cp engine and the
    dense (K5) and paged (K4) batchers with make_mesh(1, 1) against the
    same without a mesh, bit for bit."""
    import numpy as np
    import torch
    from qwen3_tts_tpu_torch.config import TalkerConfig, TTSConfig
    from qwen3_tts_tpu_torch.engine.engine import TTSEngine
    from qwen3_tts_tpu_torch.io.weights import init_random_params
    from qwen3_tts_tpu_torch.serve.batching import ContinuousBatcher
    params = init_random_params(TTSConfig(), seed=0, dtype=torch.bfloat16,
                                device="cuda")
    grew = dict.fromkeys(counters, 0)
    info = {"tokens": 0, "engine_s": 0.0, "loop_steps": 0,
            "batcher_s": 0.0}

    def counted(fn):
        before = _launches(counters)
        out = fn()
        for k, v in _grew(before, counters).items():
            grew[k] += v
        return out

    one = TTSEngine(TTSConfig(), params=params, quantize="int8-cp",
                    device="cuda")
    eng = TTSEngine(TTSConfig(), params=params, quantize="int8-cp",
                    mesh=mesh)
    for i, text in enumerate(TEXTS):
        want = one.synthesize(text, seed=i, max_tokens=MESH_TOKENS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = counted(lambda: eng.synthesize(text, seed=i,
                                             max_tokens=MESH_TOKENS))
        torch.cuda.synchronize()
        info["engine_s"] += time.perf_counter() - t0
        info["tokens"] += got.n_tokens
        check(np.array_equal(got.codes, want.codes)
              and np.array_equal(got.audio_int16, want.audio_int16),
              f"mesh leg a: engine request {i} differs from no mesh")
    cfg = TTSConfig(talker=TalkerConfig(attention_impl="pallas"))
    for paged in (False, True):
        kw = dict(paged=True, page_size=64) if paged else {}
        runs = []
        for m in (None, mesh):
            b = ContinuousBatcher(cfg, params, batch_size=4,
                                  decode_chunk=16, device="cuda", mesh=m,
                                  **kw)
            run = (counted if m is not None else (lambda f: f()))(
                lambda: _mesh_serve(b, BATCH_TEXTS, MESH_TOKENS,
                                    MESH_STREAMING))
            runs.append(run["served"])
            if m is not None:
                info["batcher_s"] += run["wall"]
                info["loop_steps"] += run["steps"] * b.decode_chunk
            del b
        for i, (c, a, s) in runs[0].items():
            c1, a1, s1 = runs[1][i]
            check(np.array_equal(c, c1) and np.array_equal(a, a1)
                  and np.array_equal(s, s1),
                  f"mesh leg a: {'paged' if paged else 'dense'} batcher "
                  f"request {i} differs from no mesh")
    return {"launches": grew, **info}


def _mesh_leg_b(mesh, counters: dict, out: dict) -> dict:
    """dp = 2 x tp = 1: the dense (K5) and paged (K4) batchers on this
    rank's half of the slots; the served requests go to ``out``."""
    import torch
    from qwen3_tts_tpu_torch.config import TalkerConfig, TTSConfig
    from qwen3_tts_tpu_torch.io.weights import init_random_params
    from qwen3_tts_tpu_torch.serve.batching import ContinuousBatcher
    params = init_random_params(TTSConfig(), seed=0, dtype=torch.bfloat16,
                               device="cuda")
    cfg = TTSConfig(talker=TalkerConfig(attention_impl="pallas"))
    info = {"loop_steps": 0, "batcher_s": 0.0}
    for fn in counters.values():
        fn.launches = 0
    for paged in (False, True):
        kw = dict(paged=True, page_size=64) if paged else {}
        b = ContinuousBatcher(cfg, params, batch_size=4, decode_chunk=16,
                              mesh=mesh, **kw)
        run = _mesh_serve(b, BATCH_TEXTS, 48, MESH_STREAMING)
        tag = "paged" if paged else "dense"
        for i, (c, a, s) in run["served"].items():
            out[f"{tag}_codes{i}"], out[f"{tag}_audio{i}"] = c, a
            out[f"{tag}_segments{i}"] = s
        out[f"{tag}_owned"] = sorted(run["served"])
        info["batcher_s"] += run["wall"]
        info["loop_steps"] += run["steps"] * b.decode_chunk
        del b
    return {"launches": _launches(counters), **info}


def _first_step(eng, text: str, seed: int):
    """The talker hidden the first decode step reads (after the prefill)
    and its codec logits, f32 on the host."""
    from qwen3_tts_tpu_torch.models import talker as tk
    ids, n = eng._encode_text(text)
    st = eng._prefill(ids, n, seed, MESH_TP_TOKENS)
    logits = tk.codec_logits(eng._tp, st.hidden, eng.mesh)
    return st.hidden.float().cpu().numpy(), logits.float().cpu().numpy()


PROBE_KEYS = ("talker_hidden", "talker_logits", "paged_hidden",
              "cp_logits0", "cp_logits1")


def _probe_inputs(eng, text: str, seed: int) -> dict:
    """The state a decode-step probe starts from, on one rank without a
    mesh: the request's post-prefill talker hidden and KV cache and its
    position, code_0 (the argmax of the first logits) with its
    codec_embedding as the talker's feedback and the code predictor's
    second input, and group 1's token (the argmax of the code
    predictor's first logits), as f32 numpy."""
    import torch
    ids, n = eng._encode_text(text)
    st = eng._prefill(ids, n, seed, MESH_TP_TOKENS)
    code0 = _decode_probe(eng, {"hidden": st.hidden}, None, "code0")
    c0e = eng._tp["codec_embedding"][code0]
    tok0 = _decode_probe(eng, {"hidden": st.hidden, "c0e": c0e}, None,
                         "tok0")
    return {k: v.float().cpu().numpy() for k, v in (
        ("hidden", st.hidden), ("kv", st.kv), ("pos", st.pos),
        ("c0e", c0e), ("tok0", tok0))}


def _decode_probe(eng, inp: dict, mesh, only: str = "") -> dict:
    """One decode step of eng's weights from the state ``inp`` (tensors
    on the card; the KV whole, cut here to the rank's kv heads): the
    talker's step on the dense cache (K5 under attention_impl="pallas")
    and on the same rows in pages of 64 (K4), each with its codec
    logits, and the code predictor's 2-token prefill and first AR step
    (its int8 products on K1), each with its lm_head logits; all under
    ``mesh`` (None: one rank). ``only`` "code0" / "tok0": the argmax of
    the talker's / the code predictor's first logits alone."""
    import torch
    from qwen3_tts_tpu_torch.models import code_predictor as tcp
    from qwen3_tts_tpu_torch.models import talker as tk
    from qwen3_tts_tpu_torch.models import transformer as tfm
    from qwen3_tts_tpu_torch.ops import quant
    from qwen3_tts_tpu_torch.parallel import mesh as pmesh
    tcfg, ccfg = eng.cfg.talker, eng.cfg.code_predictor
    tp, cpp = eng._tp, eng._cpp
    hidden = inp["hidden"]
    if only == "code0":
        return tk.codec_logits(tp, hidden, mesh).argmax(-1)
    out = {}
    dev = hidden.device
    # code predictor: predict_codes' prefill and first step
    geo = tfm.geometry_of(ccfg, mesh)
    kvc = tfm.init_kv_cache(geo, 1, ccfg.max_seq_len, dtype=hidden.dtype,
                            device=dev)
    x2 = tcp._project_in(cpp, torch.stack([hidden, inp["c0e"]], dim=1),
                         mesh)
    mask = tfm.causal_mask(1, 2, torch.full((1,), 2, device=dev))
    h, kvc = tfm.forward_prefill_unrolled(
        cpp.get("layers_list") or tfm._layers(cpp["layers"]), x2,
        torch.arange(2, device=dev)[None], mask, geo, kvc, mesh)
    h = tfm.rms_norm(h, cpp["final_norm"], ccfg.rms_norm_eps)[:, -1]
    out["cp_logits0"] = pmesh.tp_all_gather(
        quant.matmul(h, cpp["lm_heads"][0]), mesh)
    if only == "tok0":
        return out["cp_logits0"].argmax(-1)
    emb = tcp._project_in(cpp, cpp["codec_embs"][0][inp["tok0"]], mesh)
    h, _ = tfm.decode_step(cpp["layers"], emb,
                           torch.full((1,), 2, device=dev), kvc, geo, mesh)
    h = tfm.rms_norm(h, cpp["final_norm"], ccfg.rms_norm_eps)
    out["cp_logits1"] = pmesh.tp_all_gather(
        quant.matmul(h, cpp["lm_heads"][1]), mesh)
    # talker: dense and paged
    kv = inp["kv"]
    if mesh is not None:
        kv = pmesh.shard_leaf(kv, 4, mesh)          # (L, 2, B, S, Hkv, Dh)
    h, _ = tk.decode_step(tp, inp["c0e"], inp["pos"], kv.clone(), tcfg,
                          mesh=mesh)
    out["talker_hidden"] = h
    out["talker_logits"] = tk.codec_logits(tp, h, mesh)
    L, _, _, S, H, D = kv.shape
    pool = kv.new_zeros((L, 2, S // 64 + 1, 64, H, D))
    pool[:, :, 1:] = kv[:, :, 0].reshape(L, 2, S // 64, 64, H, D)
    paged = tfm.PagedKV(
        pool=pool,
        table=torch.arange(1, S // 64 + 1, dtype=torch.int32,
                           device=dev)[None],
        capacity=torch.full((1,), S, dtype=torch.int32, device=dev))
    h, _ = tk.decode_step(tp, inp["c0e"], inp["pos"], paged, tcfg,
                          mesh=mesh)
    out["paged_hidden"] = h
    return {k: v.float().cpu().numpy() for k, v in out.items()}


def _mesh_leg_c(mesh, counters: dict, out: dict, out_dir: str) -> dict:
    """dp = 1 x tp = 2: the int8-cp engine with K5 decode attention on the
    three texts (the first step's hidden and logits, codes and audio),
    the decode-step probe from the one-rank state, and the paged batcher
    (K4 on 4 local kv heads) on three requests; every array goes to
    ``out``."""
    import numpy as np
    import torch
    from qwen3_tts_tpu_torch.config import TalkerConfig, TTSConfig
    from qwen3_tts_tpu_torch.engine.engine import TTSEngine
    from qwen3_tts_tpu_torch.io.weights import init_random_params
    from qwen3_tts_tpu_torch.serve.batching import ContinuousBatcher
    params = init_random_params(TTSConfig(), seed=0, dtype=torch.bfloat16,
                                device="cuda")
    cfg = TTSConfig(talker=TalkerConfig(attention_impl="pallas"))
    eng = TTSEngine(cfg, params=params, quantize="int8-cp", mesh=mesh)
    info = {"tokens": 0, "engine_s": 0.0, "loop_steps": 0,
            "batcher_s": 0.0}
    for i, text in enumerate(TEXTS):
        out[f"hidden{i}"], out[f"logits{i}"] = _first_step(eng, text, i)
    # one decode step from the one-rank engine's state (phase_mesh wrote
    # it beside this leg's directory)
    with np.load(os.path.join(os.path.dirname(out_dir),
                              "c_probe.npz")) as z:
        kinds = {"pos": torch.int32, "tok0": torch.long}
        inp = {k: torch.from_numpy(z[k]).cuda().to(
            kinds.get(k, torch.bfloat16)) for k in z.files}
    for k, v in _decode_probe(eng, inp, mesh).items():
        out[f"probe_{k}"] = v
    for fn in counters.values():
        fn.launches = 0
    for i, text in enumerate(TEXTS):
        eng._prefix_cache.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.synthesize(text, seed=i, max_tokens=MESH_TP_TOKENS)
        torch.cuda.synchronize()
        info["engine_s"] += time.perf_counter() - t0
        info["tokens"] += res.n_tokens
        out[f"codes{i}"], out[f"audio{i}"] = res.codes, res.audio_int16
    b = ContinuousBatcher(cfg, params, batch_size=4, decode_chunk=16,
                          mesh=mesh, paged=True, page_size=64)
    run = _mesh_serve(b, BATCH_TEXTS[:MESH_TP_TEXTS], MESH_TP_TOKENS)
    info["batcher_s"] += run["wall"]
    info["loop_steps"] += run["steps"] * b.decode_chunk
    # three requests in four slots: slot i keeps request i's codes on
    # every tp rank, also where the rank serves none
    n = b._state.n_codes.cpu().numpy()
    codes = b._state.codes.cpu().numpy()
    for i in range(MESH_TP_TEXTS):
        out[f"paged_codes{i}"] = codes[i, :n[i]]
    return {"launches": _launches(counters), **info}


def mesh_rank(leg: str, out_dir: str) -> int:
    """One rank of phase_mesh's leg ``leg`` (a: one rank in an NCCL world
    of one; b: dp 2 x tp 1 and c: dp 1 x tp 2, two ranks on cuda:0 over
    gloo, their world from the QWEN3_TTS_* variables). Writes
    out<rank>.npz and out<rank>.json to ``out_dir``; exits 1 on any
    failure, leaving the world at once so that its peer fails too."""
    import traceback
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, ROOT)
    from qwen3_tts_tpu_torch.ops.kernels import _build
    from qwen3_tts_tpu_torch.parallel import mesh as pmesh
    from qwen3_tts_tpu_torch.parallel import multihost as mh
    rank = int(os.environ.get("QWEN3_TTS_PROCESS_ID", "0"))
    try:
        _build.load()
        counters = launch_counters()
        t0 = time.perf_counter()
        if leg == "a":
            torch.cuda.set_device(0)
            dist.init_process_group(
                "cpu:gloo,cuda:nccl", rank=0, world_size=1,
                store=dist.FileStore(os.path.join(out_dir, "store"), 1))
            mesh = pmesh.make_mesh(1, 1, ["cuda:0"])
        else:
            check(mh.init_distributed(backend="gloo", device="cuda:0"),
                  "mesh rank: no world")
            dp, tp = (2, 1) if leg == "b" else (1, 2)
            mesh = pmesh.make_mesh(dp, tp, ["cuda:0", "cuda:0"])
        arrays = {}
        with torch.inference_mode():
            if leg == "a":
                info = _mesh_leg_a(mesh, counters)
            elif leg == "b":
                info = _mesh_leg_b(mesh, counters, arrays)
            else:
                info = _mesh_leg_c(mesh, counters, arrays, out_dir)
        info.update(seconds=time.perf_counter() - t0,
                    coords=[mesh.dp_index, mesh.tp_index])
        owned = {k: arrays.pop(k) for k in list(arrays)
                 if k.endswith("_owned")}
        info.update(owned)
        np.savez(os.path.join(out_dir, f"out{rank}.npz"), **arrays)
        with open(os.path.join(out_dir, f"out{rank}.json"), "w") as f:
            json.dump(info, f)
        mh.barrier("mesh_done", timeout_s=MESH_RANK_TIMEOUT)
    except BaseException:
        traceback.print_exc()
        mh.shutdown_distributed()
        return 1
    mh.shutdown_distributed()
    return 0


def _run_mesh_leg(leg: str, n: int, root: str) -> list:
    """Start leg ``leg``'s n ranks (this script with --mesh-rank) and wait
    for them under MESH_RANK_TIMEOUT; any failing rank fails the phase
    and ends the others. Returns each rank's (json info, npz arrays)."""
    import numpy as np
    from qwen3_tts_tpu_torch.parallel import multihost as mh
    d = os.path.join(root, leg)
    os.makedirs(d)
    try:
        exits = mh.spawn_ranks(
            [sys.executable, os.path.abspath(__file__), "--mesh-rank", leg,
             d], n, d, timeout=MESH_RANK_TIMEOUT)
    except TimeoutError as e:
        check(False, f"mesh leg {leg}: {e}")
    check(all(e.code == 0 for e in exits),
          f"mesh leg {leg} failed:\n" + mh.format_exits(exits))
    outs = []
    for r in range(n):
        with open(os.path.join(d, f"out{r}.json")) as f:
            info = json.load(f)
        with np.load(os.path.join(d, f"out{r}.npz")) as z:
            outs.append((info, {k: z[k] for k in z.files}))
    return outs


def _cosine(a, b) -> float:
    import numpy as np
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _leg_line(leg: str, label: str, infos: list, card: str,
              totals: dict) -> dict:
    launches = {k: sum(i["launches"][k] for i in infos)
                for k in infos[0]["launches"]}
    for k, v in launches.items():
        totals[k] = totals.get(k, 0) + v
    seconds = max(i["seconds"] for i in infos)
    parts = [f"mesh leg {leg} ({label}): {seconds:.1f} s a rank"]
    i0 = infos[0]
    if i0.get("tokens"):
        parts.append(f"engine {1000 * i0['engine_s'] / i0['tokens']:.2f} "
                     f"ms a token ({i0['tokens']} tokens)")
    if i0.get("loop_steps"):
        parts.append(f"batcher {1000 * i0['batcher_s'] / i0['loop_steps']:.2f}"
                     f" ms a loop step ({i0['loop_steps']} steps)")
    parts.append(f"launches { {k: v for k, v in launches.items() if v} }")
    print("; ".join(parts) + f" [{card}]")
    return launches


def phase_mesh(params, card: str) -> dict:
    """The dp x tp tier at full geometry, its ranks subprocesses (the
    kernels built by this process before any rank starts), before any
    profiler session. Two ranks on one card check correctness only:
    their times are no multi-GPU speed figure. Returns the phase's
    launches by kernel, summed over its ranks."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from qwen3_tts_tpu_torch.config import TalkerConfig, TTSConfig
    from qwen3_tts_tpu_torch.engine.engine import TTSEngine
    from qwen3_tts_tpu_torch.serve.batching import ContinuousBatcher
    t_phase = time.perf_counter()
    totals: dict = {}
    root = tempfile.mkdtemp(prefix="q3mesh_")
    try:
        # a: one rank in an NCCL world of one, bit-equal to no mesh
        (info_a, _), = _run_mesh_leg("a", 1, root)
        la = _leg_line("a", "make_mesh(1, 1) over NCCL, bit-equal to no "
                       "mesh", [info_a], card, totals)
        for k in ("qmatmul", "cp_decode", "decode_attention",
                  "paged_attention"):
            check(la[k] > 0, f"mesh leg a: {k} was not launched")

        # b: dp 2 x tp 1 against the one-device batchers, bit for bit
        cfg = TTSConfig(talker=TalkerConfig(attention_impl="pallas"))
        want = {}
        for paged in (False, True):
            kw = dict(paged=True, page_size=64) if paged else {}
            b = ContinuousBatcher(cfg, params, batch_size=4,
                                  decode_chunk=16, device="cuda", **kw)
            want[paged] = _mesh_serve(b, BATCH_TEXTS, 48,
                                      MESH_STREAMING)["served"]
            del b
        outs = _run_mesh_leg("b", 2, root)
        for paged, tag in ((False, "dense"), (True, "paged")):
            owned = [o[0][f"{tag}_owned"] for o in outs]
            check(sorted(owned[0] + owned[1]) == list(range(
                len(BATCH_TEXTS))) and not set(owned[0]) & set(owned[1]),
                f"mesh leg b: {tag} served sets {owned} do not partition "
                "the requests")
            for _, arr in outs:
                for i in [int(k[len(tag) + 6:]) for k in arr
                          if k.startswith(f"{tag}_codes")]:
                    c, a, s = want[paged][i]
                    check(np.array_equal(arr[f"{tag}_codes{i}"], c)
                          and np.array_equal(arr[f"{tag}_audio{i}"], a)
                          and np.array_equal(arr[f"{tag}_segments{i}"], s),
                          f"mesh leg b: {tag} request {i} differs from the "
                          "one-device batcher")
            print(f"mesh leg b: {tag} batcher, ranks served {owned}, every "
                  "request's codes, audio and stream segments equal to the "
                  f"one-device batcher's bit for bit [{card}]")
        lb = _leg_line("b", "dp2 x tp1, two ranks on one card over gloo",
                       [o[0] for o in outs], card, totals)
        for k in ("qmatmul", "cp_decode", "decode_attention",
                  "paged_attention"):
            check(lb[k] > 0, f"mesh leg b: {k} was not launched")

        # c: dp 1 x tp 2 against the one-rank int8-cp engine
        one = TTSEngine(cfg, params=params, quantize="int8-cp",
                        device="cuda")
        ref = {}
        for i, text in enumerate(TEXTS):
            ref[f"hidden{i}"], ref[f"logits{i}"] = _first_step(one, text, i)
            one._prefix_cache.clear()
            ref[f"codes{i}"] = one.synthesize(
                text, seed=i, max_tokens=MESH_TP_TOKENS).codes
        with torch.inference_mode():
            probe = _probe_inputs(one, TEXTS[0], 0)
            np.savez(os.path.join(root, "c_probe.npz"), **probe)
            kinds = {"pos": torch.int32, "tok0": torch.long}
            ref_probe = _decode_probe(one, {
                k: torch.from_numpy(v).cuda().to(kinds.get(k, torch.bfloat16))
                for k, v in probe.items()}, None)
        del one
        outs = _run_mesh_leg("c", 2, root)
        (_, r0), (_, r1) = outs
        # the same state, one decode step: K5 and K4 on the rank's kv
        # heads and K1 on its code predictor shards against one rank
        cos = {}
        for k in PROBE_KEYS:
            check(np.array_equal(r0[f"probe_{k}"], r1[f"probe_{k}"]),
                  f"mesh leg c: the tp ranks' probe {k} differs")
            cos[k] = _cosine(r0[f"probe_{k}"], ref_probe[k])
        print(f"mesh leg c: one decode step from the one-rank state "
              f"(text 0, pos {int(probe['pos'][0])}), tp 2 against one rank, "
              f"cosine {', '.join(f'{k} {v:.6f}' for k, v in cos.items())}; "
              f"equal on both ranks [{card}]")
        check(min(cos.values()) >= 0.999,
              f"mesh leg c: a decode step under tp is off one rank's: {cos}")
        for i in range(len(TEXTS)):
            check(np.array_equal(r0[f"codes{i}"], r1[f"codes{i}"])
                  and np.array_equal(r0[f"audio{i}"], r1[f"audio{i}"]),
                  f"mesh leg c: the tp ranks' request {i} differs")
            n = len(r0[f"codes{i}"])
            check(1 <= n <= MESH_TP_TOKENS,
                  f"mesh leg c: request {i} gave {n} tokens")
            ch, cl = (_cosine(r0[f"hidden{i}"], ref[f"hidden{i}"]),
                      _cosine(r0[f"logits{i}"], ref[f"logits{i}"]))
            w = ref[f"codes{i}"]
            m = min(n, len(w))
            share = (float((r0[f"codes{i}"][:m] == w[:m]).mean())
                     if m else 0.0)
            print(f"mesh leg c: request {i}: {n} tokens (one rank {len(w)})"
                  f", first step cosine hidden {ch:.6f} logits {cl:.6f}, "
                  f"equal codes {share:.4f} of the first {m} x 16 (bf16 "
                  f"in another order; not bounded) [{card}]")
            check(ch >= 0.999 and cl >= 0.999,
                  f"mesh leg c: request {i} cosine {ch} / {cl} < 0.999")
        for i in range(MESH_TP_TEXTS):
            check(np.array_equal(r0[f"paged_codes{i}"],
                                 r1[f"paged_codes{i}"])
                  and len(r0[f"paged_codes{i}"]) >= 1,
                  f"mesh leg c: paged request {i} differs between ranks")
        print(f"mesh leg c: paged batcher, {MESH_TP_TEXTS} requests, codes "
              f"equal on both tp ranks [{card}]")
        lc = _leg_line("c", "dp1 x tp2, two ranks on one card over gloo",
                       [o[0] for o in outs], card, totals)
        for k in ("qmatmul", "decode_attention", "paged_attention"):
            check(lc[k] > 0, f"mesh leg c: {k} was not launched")
        check(lc["cp_decode"] == 0 and lc["talker_step"] == 0,
              "mesh leg c: K2 or K3 launched under tp")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.synchronize()
    print(f"mesh phase: {time.perf_counter() - t_phase:.1f} s; two ranks "
          "on one card check correctness only, not multi-GPU speed; "
          f"launches {totals} [{card}]")
    return totals


# ---------------------------------------------------------------------------
# phase_daemon_mesh: the batched daemon over a dp 2 x tp 1 mesh of two ranks
# (serve/lockstep.py), both on the one card over gloo; phase_quality: the
# int8 dossier; phase_soak: the serving soak
# ---------------------------------------------------------------------------

# the second wave of the daemon phase: (text, seed, max_tokens, voice)
DAEMON_WAVE2 = ((TEXTS[2], 7, SERVE_MAX_TOKENS, "clone"),
                (TEXTS[0], 8, 5, None))
DAEMON_VANISH = (LONG_TEXT, 9)              # its client leaves mid-decode
DAEMON_AFTER = (TEXTS[1], 10, SERVE_MAX_TOKENS)
DAEMON_RANK_TIMEOUT = 600
DAEMON_FLAGS = ("--batch", "4", "--tp", "1", "--dp", "2", "--decode_chunk",
                "32", "--python_loop")
QUALITY_STEPS = 32
# the soak's submissions last SOAK_SECONDS; its requests stop at
# SOAK_MAX_TOKENS, so that the drain after them stays short
SOAK_SECONDS = 6.0
SOAK_MAX_TOKENS = 64


def daemon_rank(out_dir: str, argv: list) -> int:
    """One rank of phase_daemon_mesh's daemon: serve/lockstep.rank_main
    (the rank entry of the daemon's own launcher) on cuda:0 over gloo,
    its launch counters from 0; writes rank<r>.json (its summary at the
    stop and its launches) to ``out_dir``."""
    from qwen3_tts_tpu_torch.ops.kernels import _build
    from qwen3_tts_tpu_torch.serve import lockstep
    _build.load()
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0

    def report(summary: dict) -> None:
        summary["launches"] = _launches(counters)
        with open(os.path.join(out_dir, f"rank{summary['rank']}.json"),
                  "w") as f:
            json.dump(summary, f)

    return lockstep.rank_main(argv, backend="gloo", device="cuda:0",
                              report=report)


def _vanish(sock: str, text: str, seed: int) -> None:
    """A streaming client that sends its request and leaves: the daemon
    finds it gone at its first frame and withdraws the request."""
    import socket
    import struct
    msg = json.dumps({"text": text, "seed": seed, "stream": True}).encode()
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    c.connect(sock)
    c.sendall(struct.pack("<I", len(msg)) + msg)
    c.close()


def _daemon_waves(sock: str, vanish: bool) -> dict:
    """Wave 1: _batched_run's six concurrent clients (two streaming).
    Wave 2 together: a cloned request (the registry's voice), a capped
    one and, with ``vanish``, a client that leaves mid-decode; once the
    daemon counts that request as failed, one more request."""
    import threading
    from qwen3_tts_tpu_torch.serve.daemon import DaemonClient
    out = {"wave1": _batched_run(sock)}
    got, errors = {}, []

    def call(i, text, seed, cap, voice):
        try:
            got[i] = DaemonClient(sock).synthesize(
                text, seed=seed, max_tokens=cap, voice=voice)
        except Exception as e:     # reported below, on the main thread
            errors.append((i, e))

    threads = [threading.Thread(target=call, args=(i, *w))
               for i, w in enumerate(DAEMON_WAVE2)]
    for th in threads:
        th.start()
    if vanish:
        _vanish(sock, *DAEMON_VANISH)
    for th in threads:
        th.join(timeout=600)
    check(not errors and len(got) == len(DAEMON_WAVE2),
          f"daemon wave 2: {errors}")
    if vanish:
        deadline = time.time() + 120
        while DaemonClient(sock).stats()["errors"] < 1:
            check(time.time() < deadline, "daemon: the vanished client's "
                  "request was never withdrawn")
            time.sleep(0.05)
    text, seed, cap = DAEMON_AFTER
    got["after"] = DaemonClient(sock).synthesize(text, seed=seed,
                                                 max_tokens=cap)
    out["wave2"] = got
    out["stats"] = DaemonClient(sock).stats()
    return out


def _start_daemon_ranks(label: str, root: str, voices: str,
                        paged: bool) -> dict:
    """The two ranks of a dp 2 daemon (this script with --daemon-rank),
    started by multihost.spawn_ranks on a thread of its own."""
    import threading
    from qwen3_tts_tpu_torch.parallel import multihost as mh
    d = os.path.join(root, label)
    os.makedirs(d)
    sock = os.path.join(root, f"{label}.sock")
    argv = [*DAEMON_FLAGS, "--socket", sock, "--voices", voices] + (
        ["--paged"] if paged else [])
    run = {"dir": d, "sock": sock, "procs": [], "exits": None,
           "error": None}

    def spawn():
        try:
            run["exits"] = mh.spawn_ranks(
                [sys.executable, os.path.abspath(__file__), "--daemon-rank",
                 d, *argv], 2, d, timeout=DAEMON_RANK_TIMEOUT,
                on_start=run["procs"].extend)
        except Exception as e:     # reported on the main thread
            run["error"] = e

    run["thread"] = threading.Thread(target=spawn, daemon=True)
    run["thread"].start()
    return run


def _stop_daemon_ranks(label: str, run: dict) -> list:
    """SIGTERM to rank 0 (it drains and stops both ranks); both must exit
    0. Returns the two ranks' reports."""
    import signal
    from qwen3_tts_tpu_torch.parallel import multihost as mh
    if run["procs"] and run["procs"][0].poll() is None:
        run["procs"][0].send_signal(signal.SIGTERM)
    run["thread"].join(timeout=120)
    check(run["error"] is None, f"daemon {label}: {run['error']}")
    check(run["exits"] is not None and all(e.code == 0
                                           for e in run["exits"]),
          f"daemon {label}: a rank failed:\n"
          + mh.format_exits(run["exits"] or []))
    check(not os.path.exists(run["sock"]),
          f"daemon {label}: the socket was left behind")
    reports = []
    for r in range(2):
        with open(os.path.join(run["dir"], f"rank{r}.json")) as f:
            reports.append(json.load(f))
    return reports


def phase_daemon_mesh(bf16, params, card: str) -> dict:
    """The batched daemon (bf16 talker, int8 code predictor, 4 slots,
    decode_chunk 32, depth 2) over dp 2 x tp 1, its two ranks on the one
    card over gloo, dense then paged: every request equal bit for bit to
    the one-rank batched daemon (a one-rank mesh, in this process) on the
    same requests and seeds; every slot and page free on both ranks at
    the stop; the vanished client cancelled on both. Both daemons start
    while the one-rank daemons serve. Returns K1, K2, K4's launches
    summed over the ranks."""
    import shutil
    import tempfile
    import threading
    import numpy as np
    from qwen3_tts_tpu_torch.config import TTSConfig
    from qwen3_tts_tpu_torch.parallel import multihost as mh
    from qwen3_tts_tpu_torch.serve import daemon as dm
    from qwen3_tts_tpu_torch.serve.batching import ContinuousBatcher
    from qwen3_tts_tpu_torch.serve.voices import VoiceRegistry
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="q3dm_")
    runs = {}
    try:
        voice_dir = os.path.join(root, "voices", "clone")
        os.makedirs(voice_dir)
        np.save(os.path.join(voice_dir, "ref_codec_tokens.npy"),
                np.random.default_rng(7).integers(
                    0, 2048, (CLONE_FRAMES, 16)).astype(np.int64))
        with open(os.path.join(voice_dir, "ref_text.txt"), "w") as f:
            f.write(CLONE_TEXT)
        voices = os.path.join(root, "voices")
        for paged in (False, True):
            label = "paged" if paged else "dense"
            runs[label] = _start_daemon_ranks(label, root, voices, paged)
        # the one-rank daemons, in this process, while the ranks start
        one = {}
        for paged in (False, True):
            label = "paged" if paged else "dense"
            kw = dict(paged=True, page_size=64) if paged else {}
            b = ContinuousBatcher(
                TTSConfig(), params, batch_size=4, decode_chunk=32,
                pipeline_depth=2, prefix_cache=8,
                mesh=mh.make_serving_mesh(tp=1, dp=1, devices=["cuda"]),
                **kw)
            d = dm.TTSDaemon(bf16, os.path.join(root, f"one_{label}.sock"),
                             batcher=b, voices=VoiceRegistry(voices))
            t = threading.Thread(target=d.serve, daemon=True)
            t.start()
            try:
                _wait_socket(d.socket_path)
                one[label] = _daemon_waves(d.socket_path, vanish=False)
            finally:
                d.stop()
                t.join(timeout=60)
            del b
        totals = {}
        for label, run in runs.items():
            paged = label == "paged"
            deadline = time.time() + DAEMON_RANK_TIMEOUT
            while not os.path.exists(run["sock"]):
                check(run["exits"] is None and run["error"] is None,
                      f"daemon {label}: the ranks ended before serving:\n"
                      + mh.format_exits(run["exits"] or []))
                check(time.time() < deadline,
                      f"daemon {label}: the socket never appeared")
                time.sleep(0.1)
            got = _daemon_waves(run["sock"], vanish=True)
            reports = _stop_daemon_ranks(label, run)
            want = one[label]
            w1, o1 = got["wave1"], want["wave1"]
            for i in range(len(BATCH_TEXTS)):
                check(w1["n_tokens"][i] == o1["n_tokens"][i] > 0
                      and np.array_equal(w1["audio"][i], o1["audio"][i]),
                      f"daemon {label}: request {i} differs from the "
                      "one-rank daemon")
            for k, (hdr, audio) in got["wave2"].items():
                whdr, waudio = want["wave2"][k]
                check(hdr["n_tokens"] == whdr["n_tokens"] > 0
                      and np.array_equal(audio, waudio),
                      f"daemon {label}: wave-2 request {k} differs from "
                      "the one-rank daemon")
            check(got["wave2"][1][0]["n_tokens"] <= 5,
                  f"daemon {label}: the capped request ran past its cap")
            check(reports[0]["steps"] == reports[1]["steps"],
                  f"daemon {label}: the ranks stepped {reports[0]['steps']}"
                  f" and {reports[1]['steps']} times")
            for r in reports:
                check(r["active_slots"] == 0 and r["queued"] == 0,
                      f"daemon {label}: rank {r['rank']} holds a slot or a "
                      f"request at the stop: {r}")
                check(r["cancelled"] == 1, f"daemon {label}: rank "
                      f"{r['rank']} cancelled {r['cancelled']} requests")
                if paged:
                    check(r["free_pages"] == r["usable_pages"],
                          f"daemon {label}: rank {r['rank']} has "
                          f"{r['free_pages']} of {r['usable_pages']} pages")
            launches = {k: sum(r["launches"][k] for r in reports)
                        for k in reports[0]["launches"]}
            for k, v in launches.items():
                totals[k] = totals.get(k, 0) + v
            kernels = ("qmatmul", "cp_decode") + (
                ("paged_attention",) if paged else ())
            for k in kernels:
                check(launches[k] > 0, f"daemon {label}: {k} was not "
                      "launched")
            first = [f for f in w1["first"] if f is not None]
            print(f"daemon dp2 x tp1 {label} (two ranks on one card over "
                  f"gloo): audio-s per wall-s {w1['audio_s'] / w1['wall']:.4f}"
                  f" (one-rank daemon {o1['audio_s'] / o1['wall']:.4f}), "
                  f"streaming first frame p50 "
                  f"{np.percentile(first, 50):.4f} s (one-rank "
                  f"{np.percentile(o1['first'], 50):.4f} s); "
                  f"{len(BATCH_TEXTS) + len(got['wave2'])} requests equal to "
                  f"the one-rank daemon's bit for bit (blobs, 2 streams, a "
                  f"voice, a capped one); the vanished client cancelled on "
                  f"both ranks; at the stop every slot "
                  f"{'and page ' if paged else ''}free on both, "
                  f"{reports[0]['steps']} steps each, served "
                  f"{[r['served'] for r in reports]}; launches K1 "
                  f"{launches['qmatmul']} K2 {launches['cp_decode']} K4 "
                  f"{launches['paged_attention']} [{card}]")
    finally:
        for label, run in runs.items():
            for p in run["procs"]:
                if p.poll() is None:
                    p.kill()
        shutil.rmtree(root, ignore_errors=True)
    print(f"daemon mesh phase: {time.perf_counter() - t_phase:.1f} s; two "
          "ranks on one card check correctness only, not multi-GPU speed; "
          f"launches over the ranks K1 {totals['qmatmul']} K2 "
          f"{totals['cp_decode']} K4 {totals['paged_attention']} [{card}]")
    return totals


def phase_quality(params, card: str, counters: dict) -> dict:
    """The int8 quality dossier (qwen3_tts_tpu_torch/tools/quality_check)
    at full geometry: int8 and int8-cp against bf16 on the three texts,
    QUALITY_STEPS greedy steps. int8 launches K3, K2 and K1; int8-cp K2
    and K1 and no K3, and leaves the dense talker exact (teacher-forced
    hiddens at cosine 1, code_0 all equal). Prints the tool's JSON line;
    returns its summary."""
    import dataclasses
    from qwen3_tts_tpu_torch.config import TTSConfig
    from qwen3_tts_tpu_torch.tools import quality_check as qc
    t_phase = time.perf_counter()
    cfg = qc.greedy_config(dataclasses.replace(TTSConfig(),
                                               max_tokens=QUALITY_STEPS))
    ref = qc.build_engine(cfg, params, None, "cuda")
    report, grew = {}, {}
    for v in ("int8", "int8-cp"):
        var = qc.build_engine(cfg, params, v, "cuda")
        before = _launches(counters)
        report[v] = qc.compare_variant(ref, var, TEXTS, 0, QUALITY_STEPS)
        grew[v] = _grew(before, counters)
        del var
    del ref
    for k in ("talker_step", "cp_decode", "qmatmul"):
        check(grew["int8"][k] > 0, f"dossier int8: {k} was not launched")
    check(grew["int8-cp"]["cp_decode"] > 0 and grew["int8-cp"]["qmatmul"] > 0
          and grew["int8-cp"]["talker_step"] == 0,
          f"dossier int8-cp: launches {grew['int8-cp']}")
    a = report["int8-cp"]
    check(a["tf_cos_min"] >= 1.0 - 1e-9 and a["tf_code0_agree"] == 1.0,
          f"dossier int8-cp: the dense talker is not exact: {a}")
    for v, a in report.items():
        for k in ("tf_code0_agree", "tf_row_agree", "code0_agree",
                  "row_agree", "prefix_frac", "int16_match"):
            check(0.0 <= a[k] <= 1.0, f"dossier {v}: {k} {a[k]}")
        check(a["tf_cos_min"] >= 0.99,
              f"dossier {v}: tf_cos_min {a['tf_cos_min']} < 0.99")
    line = qc.summary_line(report, "real", "random", 0, len(TEXTS))
    print(f"dossier: {QUALITY_STEPS} greedy steps a text, {len(TEXTS)} "
          f"texts, in {time.perf_counter() - t_phase:.1f} s; launches int8 "
          f"K3 {grew['int8']['talker_step']} K2 {grew['int8']['cp_decode']}"
          f" K1 {grew['int8']['qmatmul']}, int8-cp K2 "
          f"{grew['int8-cp']['cp_decode']} K1 {grew['int8-cp']['qmatmul']} "
          f"K3 {grew['int8-cp']['talker_step']} [{card}]")
    print(f"dossier line: {line}")
    return json.loads(line)


def phase_soak(params, card: str, counters: dict) -> dict:
    """The serving soak (qwen3_tts_tpu_torch/tools/soak_daemon) at full
    geometry (the bf16 weights, requests of at most SOAK_MAX_TOKENS),
    SOAK_SECONDS dense then paged at pipeline_depth 2: it must end
    healthy. Returns the kernels' launches."""
    import dataclasses
    from qwen3_tts_tpu_torch.config import TTSConfig
    from qwen3_tts_tpu_torch.engine.engine import TTSEngine
    from qwen3_tts_tpu_torch.tools.soak_daemon import soak
    eng = TTSEngine(dataclasses.replace(TTSConfig(),
                                        max_tokens=SOAK_MAX_TOKENS),
                    params=params, device="cuda")
    totals = {}
    for paged in (False, True):
        label = "paged" if paged else "dense"
        before = _launches(counters)
        out = soak(seconds=SOAK_SECONDS, batch=4, decode_chunk=32,
                   paged=paged, pipeline_depth=2, engine=eng)
        grew = _grew(before, counters)
        for k, v in grew.items():
            totals[k] = totals.get(k, 0) + v
        check(out["healthy"], f"soak {label}: not healthy: {out}")
        check(out["ok"] > 0 and out["cancelled"] > 0,
              f"soak {label}: served {out['ok']}, cancelled "
              f"{out['cancelled']}")
        for k in ("qmatmul", "cp_decode") + (
                ("paged_attention",) if paged else ()):
            check(grew[k] > 0, f"soak {label}: {k} was not launched")
        print(f"soak {label}: {out['submitted']} requests in "
              f"{out['wall_s']:.1f} s, ok {out['ok']}, cancelled "
              f"{out['cancelled']} ({out['cancelled_mid']} mid-decode), "
              f"audio-s per wall-s {out['audio_s_per_wall_s']:.4f}, "
              f"healthy (every Future resolved, every slot"
              f"{' and page' if paged else ''} free, no step failed, "
              f"streams equal to their audio); launches K1 "
              f"{grew['qmatmul']} K2 {grew['cp_decode']} K4 "
              f"{grew['paged_attention']} [{card}]")
    return totals


def main() -> int:
    t_start = time.perf_counter()
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
    if sys.argv[1:2] == ["--mesh-rank"]:
        return mesh_rank(sys.argv[2], sys.argv[3])
    if sys.argv[1:2] == ["--daemon-rank"]:
        return daemon_rank(sys.argv[2], sys.argv[3:])

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    from qwen3_tts_tpu_torch.ops.kernels import _build
    from qwen3_tts_tpu_torch.utils import profiling
    _build.load()
    build = profiling.entries("build")[-1]
    print(f"kernels built+loaded in {build.seconds:.1f} s "
          f"(nvcc ran: {build.attrs['nvcc']}) -> {_build.library_path()}")

    from qwen3_tts_tpu_torch.config import TTSConfig
    from qwen3_tts_tpu_torch.engine.engine import TTSEngine
    from qwen3_tts_tpu_torch.io.weights import init_random_params

    t0 = time.perf_counter()
    eng = TTSEngine(TTSConfig(), quantize="int8", device="cuda", seed=0)
    torch.cuda.synchronize()
    print(f"engine (random int8 weights, full geometry) ready in "
          f"{time.perf_counter() - t0:.1f} s")

    k5 = phase_decode_attention(card)
    kernels = [*phase_qmatmul(card), phase_talker_step(eng, card),
               *phase_talker_merged(eng, card), phase_cp_decode(eng, card),
               k5, phase_paged_attention(card),
               phase_kv_int8(card, k5["shapes"])]
    phase_prefill_tile(eng, card)
    counters = launch_counters()
    chunked = phase_chunked_prefill(eng, card, counters)
    # the int8-KV probe's steps and the streaming phases are timed before
    # the first profiler session
    kv8 = phase_bench_kv_int8(card, counters)
    params = init_random_params(TTSConfig(), seed=0,
                                dtype=torch.bfloat16, device="cuda")
    stream = phase_stream_engine(eng, card, counters)
    phase_stream_batcher(params, card, counters)
    phase_chunked_vocoder(eng, card)
    phase_engine_surface(eng, params, card, counters)
    phase_checkpoint(eng, params, card, counters)
    phase_serving(eng, params, card, counters)
    tp_err = phase_tp_kernels(params, card)
    mesh = phase_mesh(params, card)
    bf16 = TTSEngine(TTSConfig(), params=params, device="cuda")
    daemon_mesh = phase_daemon_mesh(bf16, params, card)
    del bf16
    soaked = phase_soak(params, card, counters)
    phase_quality(params, card, counters)
    by_name = {k["name"]: k for k in kernels}
    phase_kernel_profiles(eng, card, by_name["talker_step"],
                          by_name["cp_decode"])
    launches = phase_slice(eng, card, counters)
    for k in ("qmatmul", "talker_step", "cp_decode"):
        check(launches[k] > 0, f"{k} never launched in the slice")
    phase_profile(eng, card)
    del eng
    launches.update(phase_batcher(params, card, counters))
    del params
    phase_synth_batch(card, counters)
    launches.update(kv8)
    launches.update(phase_microbench_merged(card, counters))
    phase_cli(card)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["launches_mesh"] = mesh.get(k["name"], 0)
        k["launches_daemon_mesh"] = daemon_mesh.get(k["name"], 0)
        k["launches_soak"] = soaked.get(k["name"], 0)
        k["launches_chunked_prefill"] = chunked.get(k["name"], 0)
        k["launches_stream"] = {m: n.get(k["name"], 0)
                                for m, n in stream.items()}
        if k["name"] in tp_err:
            k["max_abs_err_tp_shards"] = tp_err[k["name"]]
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
