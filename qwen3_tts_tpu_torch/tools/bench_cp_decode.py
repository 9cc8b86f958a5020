"""Time K2 (the code predictor's 14 AR steps, ops/kernels/cp_decode.py)
on one NVIDIA GPU at the full code-predictor geometry (5 int8 layers,
hidden 1024, 16 query / 8 KV heads of 128, intermediate 3072, group
vocab 2048, S 16), at B = 1, 4 and 8, with random int8 weights from a
seed and the sampled path (T 0.1, top-k 50) that the engine runs.

For each B: the device time of a call under CUDA-graph replay, the time
of an eager call (the host's Python and ctypes included), the host's
time to enqueue one call (from an idle device), and the weight
rate: the bytes each step must stream (the int8 layer stack and its
scales, one lm_head, the mtp projection; the stack and heads exceed the
50 MB L2, so each of the 14 steps reads them again) over the replay
time, against the streaming bound (those bytes at 3.35 TB/s). Then, once
every B is timed, calls of each under torch.profiler: device time and
count of every kernel it launched, and launches per call and per step.
(On an H100, K2 replayed a few percent slower after the process's first
profiler session, hence the order.)

    python -m qwen3_tts_tpu_torch.tools.bench_cp_decode
    python qwen3_tts_tpu_torch/tools/bench_cp_decode.py --root DIR

``--root DIR`` imports qwen3_tts_tpu_torch from another checkout of the
repository (its kernels are built there), so two versions of K2 can be
timed in turns on one card. Prints one JSON line per B.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

BATCHES = (1, 4, 8)
SEED = 5
HOST_REPS = 9                   # enqueues whose median host_ms takes
PROFILE_CALLS = 3               # calls under the profiler
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, published
PROJ = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
        "down_proj")


def kernel_kind(name: str) -> str:
    """A profiler kernel name without namespaces and argument list:
    ``qsplit_kernel<1, signed char, 0>``."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name)
    depth, cut = 0, len(name)
    for i in range(len(name) - 1, -1, -1):   # the last top-level (...)
        if name[i] == ")":
            depth += 1
        elif name[i] == "(":
            depth -= 1
            if depth == 0:
                cut = i
                break
    return name[:cut].strip()


def cp_params():
    """Random int8 code-predictor params at TTSConfig()'s geometry, on the
    card."""
    import torch
    from qwen3_tts_tpu_torch.config import TTSConfig
    from qwen3_tts_tpu_torch.io import weights
    from qwen3_tts_tpu_torch.ops import quant
    cfg = TTSConfig().code_predictor
    init = weights._Init(SEED, "cuda")
    dense = weights._code_predictor(init, cfg, torch.bfloat16)
    return cfg, quant.quantize_code_predictor(dense)


def step_bytes(params) -> int:
    """Bytes a step must stream: the int8 stack and its scales, one
    lm_head and its scales, the mtp projection."""
    lay, head = params["layers"], params["lm_heads"]
    w = params["mtp_proj_w"]
    return (sum(lay[n].q.numel() + 4 * lay[n].scale.numel() for n in PROJ)
            + head.q[1].numel() + 4 * head.scale[1].numel()
            + w.numel() * w.element_size())


def inputs(cfg, B: int, seed: int):
    """The post-prefill cache (positions 0, 1 filled), first tokens and
    seeds for B rows."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    S = cfg.max_seq_len
    kv = torch.zeros((cfg.num_layers, 2, B, S, cfg.num_kv_heads,
                      cfg.head_dim), device="cuda", dtype=torch.bfloat16)
    kv[:, :, :, :2] = (torch.randn(kv[:, :, :, :2].shape, generator=g,
                                   device="cuda") * 0.5).bfloat16()
    tok0 = torch.randint(0, cfg.group_vocab_size, (B,), generator=g,
                         device="cuda", dtype=torch.int32)
    seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (B,), generator=g,
                          device="cuda", dtype=torch.int32)
    return kv, tok0, seeds


def host_ms(fn) -> float:
    """Median host time to enqueue one call (Python, ctypes and the
    launches), from an idle device: a call's launches fit the launch
    queue, so the host never waits for the device here."""
    import statistics
    import time

    import torch
    vals = []
    for _ in range(HOST_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        vals.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(vals)


def profile_call(fn) -> dict:
    """PROFILE_CALLS calls under torch.profiler: {kernel kind: (launches
    a call, device ms a call)}."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_CALLS):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA") or e.count == 0:
            continue
        n, ms = out.get(kernel_kind(e.key), (0.0, 0.0))
        out[kernel_kind(e.key)] = (
            n + e.count / PROFILE_CALLS,
            ms + e.self_device_time_total / 1e3 / PROFILE_CALLS)
    return out


def k2_call(cfg, params, B: int):
    """A sampled K2 call at B rows, inputs from SEED + B."""
    import torch
    from qwen3_tts_tpu_torch.models import transformer as tfm
    from qwen3_tts_tpu_torch.ops.kernels.cp_decode import cp_decode_cuda
    cos, sin = tfm.rope_cos_sin(torch.arange(cfg.max_seq_len, device="cuda"),
                                cfg.head_dim, cfg.rope_theta)
    kv, tok0, seeds = inputs(cfg, B, SEED + B)
    return lambda: cp_decode_cuda(params, tok0, kv, cos, sin, seeds,
                                  eps=cfg.rms_norm_eps, top_k=50,
                                  temperature=0.1, greedy=False)


def time_cases(cfg, params, batches=BATCHES) -> list:
    """Time K2 at each B of ``batches``; one dict per B."""
    from qwen3_tts_tpu_torch.tools import time_ms
    steps = cfg.num_groups - 1
    sb = step_bytes(params)
    out = []
    for B in batches:
        k2 = k2_call(cfg, params, B)
        t_graph = time_ms(k2, 10, graph=True)
        out.append({
            "B": B, "ms": t_graph, "eager_ms": time_ms(k2, 10),
            "host_ms": host_ms(k2),
            "weight_gb_s": steps * sb / (t_graph * 1e-3) / 1e9,
            "bound_streaming_ms": steps * sb / HBM_BYTES_PER_S * 1e3})
    return out


def profile_cases(cfg, params, rows: list) -> None:
    """Add to each row of ``time_cases`` the profile of its B: launches a
    call and a step, and launches and device ms a call of each kernel."""
    steps = cfg.num_groups - 1
    for row in rows:
        prof = profile_call(k2_call(cfg, params, row["B"]))
        n_launch = sum(n for n, _ in prof.values())
        row.update({
            "launches_per_call": n_launch,
            "launches_per_step": n_launch / steps,
            "profiled_device_ms": sum(ms for _, ms in prof.values()),
            "kernels": {k: {"launches": round(n, 3), "ms": round(ms, 5)}
                        for k, (n, ms) in sorted(
                            prof.items(), key=lambda kv_: -kv_[1][1])}})


def run() -> list:
    """``time_cases``, then ``profile_cases``, on random params: every
    time is taken before the process's first torch.profiler session,
    after which a chain of dependent launches replays a few percent
    slower for the rest of the process."""
    cfg, params = cp_params()
    rows = time_cases(cfg, params)
    profile_cases(cfg, params, rows)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose qwen3_tts_tpu_torch to time "
                         "(default: this one)")
    sys.path.insert(0, ap.parse_args().root)
    import torch
    if not torch.cuda.is_available():
        print("bench_cp_decode: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    import qwen3_tts_tpu_torch
    for row in run():
        print(json.dumps({"root": qwen3_tts_tpu_torch.__path__[0], **row,
                          "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
