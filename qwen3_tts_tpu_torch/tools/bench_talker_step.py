"""Time K3 (the whole int8 talker decode step, ops/kernels/talker_step.py)
on one NVIDIA GPU at the full talker geometry (28 int8 layers, hidden
1024, 16 query / 8 KV heads of 128, intermediate 3072), with random int8
weights from a seed and a bf16 dense cache of S = 512 positions.

Cases: B = 1, 4 and 8 with every row at pos 490, the same at pos 64, and
B = 4 at positions [0, 511, 200, 37]. For each: the device time of a call
under CUDA-graph replay, the time of an eager call (the host's Python and
ctypes included), the host's time to enqueue one call (from an idle
device), the rate of the bytes a call must read (the int8
weights and their scales, the K/V rows 0..pos of every layer) over the
replay time, and the bound: every input read once and every output
written once at 3.35 TB/s (``bound_bytes``, which chip_smoke.py's K3
phase uses too). Then, once every case is timed, calls of each case
under torch.profiler: device time and count of every kernel it
launched, and launches a call. (On an H100, K2 and K3 replayed a few
percent slower after the process's first profiler session, hence the
order.)

    python -m qwen3_tts_tpu_torch.tools.bench_talker_step
    python qwen3_tts_tpu_torch/tools/bench_talker_step.py --root DIR

``--root DIR`` imports qwen3_tts_tpu_torch from another checkout of the
repository (its kernels are built there), so two versions of K3 can be
timed in turns on one card. Prints one JSON line a case.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

SEED = 7
S = 512
# (label, positions of the rows)
CASES = (("B=1 pos 490", [490]), ("B=4 pos 490", [490] * 4),
         ("B=8 pos 490", [490] * 8), ("B=1 pos 64", [64]),
         ("B=4 pos 64", [64] * 4), ("B=8 pos 64", [64] * 8),
         ("B=4 pos [0,511,200,37]", [0, 511, 200, 37]))
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, published
PRODUCTS = ("qkv_proj", "o_proj", "gateup_proj", "down_proj")
NORMS = ("input_ln", "post_ln", "q_norm", "k_norm")


def talker_layers(device: str = "cuda"):
    """The talker config and its random int8 layer stack (fused q|k|v and
    gate|up, bf16 norms) at TTSConfig()'s geometry."""
    import torch
    from qwen3_tts_tpu_torch.config import TTSConfig
    from qwen3_tts_tpu_torch.io import weights
    from qwen3_tts_tpu_torch.models import transformer as tfm
    from qwen3_tts_tpu_torch.ops import quant
    cfg = TTSConfig().talker
    init = weights._Init(SEED, device)
    dense = weights._stack(init, tfm.geometry_of(cfg), torch.bfloat16)
    return cfg, quant.quantize_layer_stack(dense, fuse=True)


def read_bytes(layers, cfg, pos) -> int:
    """Bytes a call must read from its large inputs: the int8 weights and
    their scales, and the bf16 K/V rows 0..pos of every layer and row."""
    w = sum(layers[n].q.numel() + 4 * layers[n].scale.numel()
            for n in PRODUCTS)
    rows = sum(p + 1 for p in pos)
    return w + cfg.num_layers * 2 * rows * cfg.num_kv_heads * cfg.head_dim * 2


def bound_bytes(layers, cfg, pos) -> int:
    """Every input read once (``read_bytes``, the norm weights, x in bf16)
    and every output written once (h in bf16, the f32 fresh K/V rows)."""
    B = len(pos)
    norms = sum(layers[n].numel() * layers[n].element_size() for n in NORMS)
    rows_out = cfg.num_layers * 2 * B * cfg.num_kv_heads * cfg.head_dim * 4
    return (read_bytes(layers, cfg, pos) + norms + 2 * B * cfg.hidden_size * 2
            + rows_out)


def inputs(cfg, pos, seed: int):
    """x (B, H) bf16, a bf16 cache (L, 2, B, S, nKV, Dh) and pos (B,)
    int32, as the engine's decode loop passes it."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    B = len(pos)
    x = (torch.randn((B, cfg.hidden_size), generator=g, device="cuda")
         * 0.1).bfloat16()
    kv = (torch.randn((cfg.num_layers, 2, B, S, cfg.num_kv_heads,
                       cfg.head_dim), generator=g, device="cuda")
          * 0.5).bfloat16()
    return x, kv, torch.tensor(pos, dtype=torch.int32, device="cuda")


def k3_call(cfg, layers, pos, seed: int):
    """A K3 call on ``layers`` at positions ``pos``, inputs from seed."""
    import torch
    from qwen3_tts_tpu_torch.models import transformer as tfm
    from qwen3_tts_tpu_torch.ops.kernels.talker_step import talker_step_cuda
    cos, sin = tfm.rope_cos_sin(torch.arange(S, device="cuda"),
                                cfg.head_dim, cfg.rope_theta)
    x, kv, p = inputs(cfg, pos, seed)
    return lambda: talker_step_cuda(layers, x, p, kv, cos, sin,
                                    cfg.rms_norm_eps)


def time_cases(cfg, layers, cases=CASES) -> list:
    """Time K3 on the talker stack ``layers`` (int8, fused, as
    ``talker_layers`` or the engine builds it) at each case; one dict a
    case."""
    from qwen3_tts_tpu_torch.tools import time_ms
    from qwen3_tts_tpu_torch.tools.bench_cp_decode import host_ms
    out = []
    for i, (label, pos) in enumerate(cases):
        k3 = k3_call(cfg, layers, pos, SEED + i)
        t_graph = time_ms(k3, 10, graph=True)
        out.append({
            "case": label, "B": len(pos), "pos": pos, "ms": t_graph,
            "eager_ms": time_ms(k3, 10), "host_ms": host_ms(k3),
            "gb_s": read_bytes(layers, cfg, pos) / (t_graph * 1e-3) / 1e9,
            "bound_ms": bound_bytes(layers, cfg, pos) / HBM_BYTES_PER_S
            * 1e3})
    return out


def profile_cases(cfg, layers, rows: list) -> None:
    """Add to each row of ``time_cases`` the profile of its case: launches
    a call, and launches and device ms a call of each kernel."""
    from qwen3_tts_tpu_torch.tools.bench_cp_decode import profile_call
    for i, row in enumerate(rows):
        prof = profile_call(k3_call(cfg, layers, row["pos"], SEED + i))
        row.update({
            "launches_per_call": sum(n for n, _ in prof.values()),
            "profiled_device_ms": sum(ms for _, ms in prof.values()),
            "kernels": {k: {"launches": round(n, 3), "ms": round(ms, 5)}
                        for k, (n, ms) in sorted(
                            prof.items(), key=lambda kv_: -kv_[1][1])}})


def run(cfg, layers, cases=CASES) -> list:
    """``time_cases``, then ``profile_cases``: every time is taken before
    the process's first torch.profiler session, after which a chain of
    dependent launches replays a few percent slower for the rest of the
    process."""
    rows = time_cases(cfg, layers, cases)
    profile_cases(cfg, layers, rows)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose qwen3_tts_tpu_torch to time "
                         "(default: this one)")
    sys.path.insert(0, ap.parse_args().root)
    import torch
    if not torch.cuda.is_available():
        print("bench_talker_step: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    import qwen3_tts_tpu_torch
    for row in run(*talker_layers()):
        print(json.dumps({"root": qwen3_tts_tpu_torch.__path__[0], **row,
                          "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
