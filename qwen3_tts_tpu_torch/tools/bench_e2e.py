"""End-to-end time of the port's two decode paths on one NVIDIA GPU, at
TTSConfig() (the full 0.6B geometry, random weights from a seed):

- the int8 single-request slice: TTSEngine(quantize="int8") synthesizes
  TEXTS once to warm up, then REPS more times; wall ms/token of each
  request (host clock, closed by a synchronise) and a digest of the
  warm-up pass's codes (equal digests: equal codes), then one request
  under torch.profiler: device busy ms/token, kernel launches per token
  (all, and K1's from its launch count) and the host CPU time of those
  launch calls per token, by launch call (plain and extended) with its
  host us a call, beside a gauge of the host's speed: the host us a call
  of one fixed trivial launch, profiled just before and just after the
  request;
- the continuous batcher (bf16 talker with attention_impl="pallas", int8
  code predictor, 4 slots, decode_chunk 16), dense (K5) and paged (K4,
  pages of 64): BATCH_TEXTS served twice, wall and audio-seconds per
  wall-second of each run and its wall per loop step (scheduler steps x
  decode_chunk), then one scheduler step (4 admissions and 16 loop
  steps) under the profiler: device busy ms, kernel launches and the
  attention kernel's device ms per loop step.

Device busy is the union of the kernels' intervals on the device
(``device_busy_ms``): kernels that overlap under programmatic dependent
launch count once, where a sum of kernel times would count the overlap
twice. The host of a chip machine is shared and its speed drifts, so
compare two versions only in turns in one call:

    python -m qwen3_tts_tpu_torch.tools.bench_e2e [--slice-only]
    python qwen3_tts_tpu_torch/tools/bench_e2e.py --root DIR

``--root DIR`` imports qwen3_tts_tpu_torch from another checkout (the
parent); ``--slice-only`` skips the batchers. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import sys
import time
from pathlib import Path

TEXTS = ("Привет, мир!", "Hello from the port.", "Добрый день.")
BATCH_TEXTS = ("Привет, мир!", "Hello from the port.", "Добрый день.",
               "How are you today?", "Спасибо.", "A short one.")
REPS = 2
SAMPLES_PER_S = 24000
LAUNCH_CALL = "cudaLaunchKernel"   # and cudaLaunchKernelExC


def device_busy_ms(prof) -> float:
    """The time at least one kernel (or copy) ran on the device in a
    torch.profiler trace: the union of their intervals."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if str(e.device_type).endswith("CUDA"))
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy / 1e3


def device_sum_ms(prof) -> float:
    """The sum of the same intervals: above device_busy_ms by the time
    kernels overlapped (under dependent launch a kernel's interval includes
    its wait for the one before)."""
    return sum(e.time_range.end - e.time_range.start for e in prof.events()
               if str(e.device_type).endswith("CUDA")) / 1e3


def launches(prof) -> int:
    return sum(e.count for e in prof.key_averages()
               if e.key.startswith(LAUNCH_CALL))


def launch_host_ms(prof) -> float:
    """Host CPU time spent inside the CUDA runtime's kernel-launch calls:
    what the launches alone cost the host, whatever the device does."""
    return sum(e.cpu_time_total for e in prof.key_averages()
               if e.key.startswith(LAUNCH_CALL)) / 1e3


def launch_calls(prof, n: int) -> dict:
    """Each kind of launch call (cudaLaunchKernel, cudaLaunchKernelExC):
    calls per token (n tokens) and host us a call."""
    return {e.key: {"per_token": e.count / n,
                    "host_us_a_call": e.cpu_time_total / e.count}
            for e in prof.key_averages()
            if e.key.startswith(LAUNCH_CALL) and e.count}


def host_gauge_us(calls: int = 2000) -> float:
    """Host us a call of cudaLaunchKernel for a one-element add, under
    the profiler as the request is: the same work whatever the code under
    test, so drift of the host moves it and a change of the code does
    not."""
    import torch
    t = torch.zeros(1, device="cuda")

    def adds():
        for _ in range(calls):
            t.add_(1)
    _, prof = _profile(adds)
    return launch_calls(prof, 1)["cudaLaunchKernel"]["host_us_a_call"]


def _profile(fn):
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, prof


def run_slice() -> dict:
    import torch
    from qwen3_tts_tpu_torch.config import TTSConfig
    from qwen3_tts_tpu_torch.engine.engine import TTSEngine
    from qwen3_tts_tpu_torch.ops.kernels.qmatmul import qmatmul
    eng = TTSEngine(TTSConfig(), quantize="int8", device="cuda", seed=0)
    walls, digest = [], hashlib.sha256()
    for rep in range(REPS + 1):
        for i, text in enumerate(TEXTS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = eng.synthesize(text, seed=i)
            torch.cuda.synchronize()
            if rep:   # the first pass warms up
                walls.append(1e3 * (time.perf_counter() - t0)
                             / max(res.n_tokens, 1))
            else:
                digest.update(res.codes.astype("int32").tobytes())
    gauge = [host_gauge_us()]
    k1 = qmatmul.launches
    res, prof = _profile(lambda: eng.synthesize(TEXTS[1], seed=1))
    k1 = qmatmul.launches - k1
    gauge.append(host_gauge_us())
    n = max(res.n_tokens, 1)
    return {"wall_ms_per_token": statistics.median(walls),
            "codes_sha256": digest.hexdigest()[:16],
            "k1_launches_per_token": k1 / n,
            "wall_ms_per_token_all": walls,
            "device_ms_per_token": device_busy_ms(prof) / n,
            "launches_per_token": launches(prof) / n,
            "launch_host_ms_per_token": launch_host_ms(prof) / n,
            "launch_calls": launch_calls(prof, n),
            "host_gauge_us_a_call": gauge}


def encode_text(text: str):
    """Byte-fallback ids padded to the engine's text bucket, and their
    count: a batcher submission."""
    import numpy as np
    from qwen3_tts_tpu_torch.engine.engine import _bucket
    raw = list(text.encode("utf-8"))
    ids = np.zeros((_bucket(len(raw)),), np.int32)
    ids[:len(raw)] = raw
    return ids, len(raw)


def _serve(b, texts) -> tuple:
    """Serve texts through batcher b; (wall s, audio s, scheduler
    steps)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    futs = [b.submit(*encode_text(t), seed=i) for i, t in enumerate(texts)]
    steps = 0
    while not all(f.done() for f in futs):
        b.step()
        steps += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    audio = sum(len(f.result(timeout=0)[1]) for f in futs) / SAMPLES_PER_S
    return wall, audio, steps


def attention_ms(prof) -> float:
    """Device ms of the decode attention kernels in a trace (K5 and K4
    share decode_attn_split_kernel; K4's first design was
    paged_attn_kernel)."""
    return sum(e.self_device_time_total for e in prof.key_averages()
               if ("decode_attn" in e.key or "paged_attn" in e.key)
               and str(e.device_type).endswith("CUDA")) / 1e3


def run_batcher(params, paged: bool) -> dict:
    from qwen3_tts_tpu_torch.config import TalkerConfig, TTSConfig
    from qwen3_tts_tpu_torch.serve.batching import ContinuousBatcher
    cfg = TTSConfig(talker=TalkerConfig(attention_impl="pallas"))
    kw = dict(paged=True, page_size=64) if paged else {}
    b = ContinuousBatcher(cfg, params, batch_size=4, decode_chunk=16,
                          device="cuda", **kw)
    runs = [_serve(b, BATCH_TEXTS) for _ in range(2)]
    futs = [b.submit(*encode_text(t), seed=i)
            for i, t in enumerate(BATCH_TEXTS[:4])]
    _, prof = _profile(b.step)
    while not all(f.done() for f in futs):
        b.step()
    n = b.decode_chunk
    return {"wall_s": [w for w, _, _ in runs],
            "audio_s_per_wall_s": [a / w for w, a, _ in runs],
            "wall_ms_per_loop_step": [1e3 * w / (k * n) for w, _, k in runs],
            "device_ms_per_loop_step": device_busy_ms(prof) / n,
            "launches_per_loop_step": launches(prof) / n,
            "attention_ms_per_loop_step": attention_ms(prof) / n}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose qwen3_tts_tpu_torch to time "
                         "(default: this one)")
    ap.add_argument("--slice-only", action="store_true",
                    help="time the int8 slice only, not the batcher")
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import torch
    if not torch.cuda.is_available():
        print("bench_e2e: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import qwen3_tts_tpu_torch
    out = {"root": qwen3_tts_tpu_torch.__path__[0], "slice": run_slice()}
    if not args.slice_only:
        from qwen3_tts_tpu_torch.config import TTSConfig
        from qwen3_tts_tpu_torch.io.weights import init_random_params
        params = init_random_params(TTSConfig(), seed=0, dtype=torch.bfloat16,
                                    device="cuda")
        out["batcher"] = run_batcher(params, paged=False)
        out["paged_batcher"] = run_batcher(params, paged=True)
    print(json.dumps({**out, "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
