"""Time K5 (dense decode attention, ops/kernels/decode_attention.py) on
one NVIDIA GPU at the talker's geometry (Hq 16, Hkv 8, Dh 128, S 512,
bf16), beside its byte bound and scaled_dot_product_attention on the same
inputs; K4 (paged decode attention, ops/kernels/paged_attention.py) at
the paged batcher's page geometry (pages of 64, 9 a row, a pool of B * 9
+ 1 pages with page 0 reserved, a scrambled table), B = 4 and 8, beside
its byte bound and, for reference only (no single PyTorch call pages),
SDPA over the rows the table gathers; and K6 (int8-KV decode attention,
ops/kernels/kv_int8.py) at K5's four shapes over a (B, Hkv, S, Dh) int8
cache with f32 row scales, bf16 q, beside its byte bound, K5's time at
the same positions and, for reference only (no single PyTorch call reads
an int8 cache with row scales), SDPA over the rows dequantized to bf16.

Each shape is timed as a decode step meets it, with K/V from HBM: the
calls take in turn enough K/V caches (28, a layer each, or more) that the
rows they read in one cycle are at least three times the 50 MB L2; the
calls are captured in a CUDA graph and replayed, so the time is device
time and not the host's Python and ctypes. The bound is the larger of the
bytes the call must move (q, pos, K and V rows 0..pos of every row, the
output) at 3.35 TB/s and its ~4 flops per K/V element at the f32 peak of
67 TFLOP/s.

    python -m qwen3_tts_tpu_torch.tools.bench_decode_attention
    python qwen3_tts_tpu_torch/tools/bench_decode_attention.py --root DIR

``--root DIR`` imports qwen3_tts_tpu_torch from another checkout of the
repository (its kernels are built there), so two versions of K5 can be
timed in turns on one card (K4's and K6's entry points,
paged_attention_cuda and decode_attention_kv_int8_cuda, have the same
arguments in every version). Prints one JSON line per shape.
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import sys
from pathlib import Path

# (label, B, pos) at S = 512: the batcher's step with a fresh, a full and
# two partial rows; a full batch of 8; one full row; the positions of the
# profiled batcher step
SHAPES = (("B=4 pos [0,511,200,37]", 4, [0, 511, 200, 37]),
          ("B=8 pos 511", 8, [511] * 8),
          ("B=1 pos 511", 1, [511]),
          ("B=4 pos 20-40", 4, [20, 27, 33, 40]))
S, HQ, HKV, DH, LAYERS = 512, 16, 8, 128, 28
# K4: (label, B, pos) at pages of PSZ, MAXP a row: the batcher's step
# with a fresh, a full and two partial rows (row 0 holds one page, the
# rest of its table the reserved page 0), and a full batch of 8 with
# positions on page and chunk edges (chunks of 72)
PSZ, MAXP = 64, 9
PAGED_SHAPES = (("B=4 pos [0,575,300,64]", 4, [0, 575, 300, 64]),
                ("B=8 pos [0,575,300,64,71,72,143,511]", 8,
                 [0, 575, 300, 64, 71, 72, 143, 511]))
SEED = 7
L2_BYTES = 50e6                 # H100 SXM, published
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, published
F32_FLOPS = 67e12


def kv_bytes(rows: int) -> int:
    """bf16 K and V bytes of ``rows`` positions."""
    return 2 * rows * HKV * DH * 2


def bound_ms(B: int, rows: int, extra: int = 0) -> tuple:
    """(ms, "bytes" or "operations") for B rows with ``rows`` K/V
    positions in all, bf16, and ``extra`` bytes read besides (K4's
    table)."""
    n_bytes = (B * HQ * DH * 2 + B * 4          # q, pos (int32)
               + kv_bytes(rows)                 # K and V rows 0..pos
               + B * HQ * DH * 2 + extra)       # the output
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = 4.0 * rows * HQ * DH / F32_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def kv8_bound_ms(B: int, rows: int) -> tuple:
    """K6's (ms, "bytes" or "operations"): q (bf16), pos, the int8 K and V
    rows 0..pos with their f32 scales, the output; 4 flops per K/V
    element and one product a dequantized element."""
    n_bytes = (B * HQ * DH * 2 + B * 4 + 2 * rows * HKV * (DH + 4)
               + B * HQ * DH * 2)
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = (4.0 * rows * HQ * DH + 2.0 * rows * HKV * DH) / F32_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def run() -> list:
    """Time K5 and SDPA at each shape; returns one dict per shape."""
    import torch
    import torch.nn.functional as F
    from qwen3_tts_tpu_torch.ops.kernels.decode_attention import (
        decode_attention_cuda)
    from qwen3_tts_tpu_torch.tools import time_ms
    g = torch.Generator(device="cuda").manual_seed(SEED)
    out = []
    for label, B, pl in SHAPES:
        rows = sum(p + 1 for p in pl)
        n = max(LAYERS, math.ceil(3 * L2_BYTES / kv_bytes(rows)))
        q = torch.randn((B, HQ, DH), generator=g, device="cuda").bfloat16()
        kv = torch.randn((n, 2, B, S, HKV, DH), generator=g, device="cuda",
                         dtype=torch.bfloat16)
        # int32, as the decode loop keeps its positions (engine/generate.py)
        pos = torch.tensor(pl, device="cuda", dtype=torch.int32)
        it = itertools.cycle(range(n)).__next__

        def k5():
            i = it()
            return decode_attention_cuda(q, kv[i, 0], kv[i, 1], pos)
        mask = (torch.arange(S, device="cuda")[None, :]
                <= pos[:, None])[:, None, None, :]

        def sdpa(i=None):
            i = it() if i is None else i
            return F.scaled_dot_product_attention(
                q[:, :, None], kv[i, 0].transpose(1, 2),
                kv[i, 1].transpose(1, 2), attn_mask=mask, enable_gqa=True)
        err = float((sdpa(0).reshape(B, -1).float() - decode_attention_cuda(
            q, kv[0, 0], kv[0, 1], pos).float()).abs().max())
        t_k = time_ms(k5, n, graph=True)
        t_l = time_ms(sdpa, n, graph=True)
        b_ms, b_by = bound_ms(B, rows)
        out.append({"shape": label, "ms": t_k, "library_ms": t_l,
                    "bound_ms": b_ms, "bound_by": b_by, "caches": n,
                    "mb_read_a_cycle": kv_bytes(rows) * n / 1e6,
                    "sdpa_max_abs_err": err})
        del kv
    return out


def run_paged() -> list:
    """Time K4 and SDPA over the gathered rows at each paged shape;
    returns one dict per shape."""
    import torch
    import torch.nn.functional as F
    from qwen3_tts_tpu_torch.ops.kernels.paged_attention import (
        paged_attention_cuda, paged_gather_kv)
    from qwen3_tts_tpu_torch.tools import time_ms
    g = torch.Generator(device="cuda").manual_seed(SEED)
    out = []
    for label, B, pl in PAGED_SHAPES:
        rows = sum(p + 1 for p in pl)
        n = max(LAYERS, math.ceil(3 * L2_BYTES / kv_bytes(rows)))
        P = B * MAXP + 1
        perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(B))
        table = (perm[:B * MAXP] + 1).reshape(B, MAXP).to(torch.int32).cuda()
        table[0, 1:] = 0
        q = torch.randn((B, HQ, DH), generator=g, device="cuda").bfloat16()
        pools = torch.randn((n, 2, P, PSZ, HKV, DH), generator=g,
                            device="cuda", dtype=torch.bfloat16)
        pos = torch.tensor(pl, device="cuda", dtype=torch.int32)
        it = itertools.cycle(range(n)).__next__

        def k4():
            i = it()
            return paged_attention_cuda(q, pools[i, 0], pools[i, 1], table,
                                        pos)
        kv = [paged_gather_kv(pools[i], table) for i in range(4)]
        mask = (torch.arange(MAXP * PSZ, device="cuda")[None, :]
                <= pos[:, None])[:, None, None, :]

        def sdpa(i=None):
            i = it() % 4 if i is None else i
            return F.scaled_dot_product_attention(
                q[:, :, None], kv[i][0].transpose(1, 2),
                kv[i][1].transpose(1, 2), attn_mask=mask, enable_gqa=True)
        err = float((sdpa(0).reshape(B, -1).float() - paged_attention_cuda(
            q, pools[0, 0], pools[0, 1], table, pos).float()).abs().max())
        t_k = time_ms(k4, n, graph=True)
        t_l = time_ms(sdpa, n, graph=True)
        b_ms, b_by = bound_ms(B, rows, extra=B * MAXP * 4)   # + the table
        out.append({"shape": f"K4 {label}", "ms": t_k,
                    "sdpa_gathered_reference_ms": t_l, "bound_ms": b_ms,
                    "bound_by": b_by, "pools": n,
                    "mb_read_a_cycle": kv_bytes(rows) * n / 1e6,
                    "sdpa_max_abs_err": err})
        del pools, kv
    return out


def run_kv_int8(k5_rows: list = ()) -> list:
    """Time K6 and, for reference, SDPA over the dequantized rows at each
    of SHAPES; ``k5_rows`` (run()'s) puts K5's time at the same positions
    beside each. Returns one dict per shape."""
    import torch
    import torch.nn.functional as F
    from qwen3_tts_tpu_torch.ops.kernels.kv_int8 import (
        decode_attention_kv_int8_cuda)
    from qwen3_tts_tpu_torch.tools import time_ms
    k5 = {r["shape"]: r["ms"] for r in k5_rows}
    g = torch.Generator(device="cuda").manual_seed(SEED)
    out = []
    for label, B, pl in SHAPES:
        rows = sum(p + 1 for p in pl)
        n = max(LAYERS, math.ceil(3 * L2_BYTES / (2 * rows * HKV * (DH + 4))))
        q = torch.randn((B, HQ, DH), generator=g, device="cuda").bfloat16()
        kvq = torch.randint(-127, 128, (n, 2, B, HKV, S, DH), generator=g,
                            device="cuda", dtype=torch.int8)
        kvs = torch.rand((n, 2, B, HKV, S), generator=g, device="cuda") * 0.02
        pos = torch.tensor(pl, device="cuda", dtype=torch.int32)
        it = itertools.cycle(range(n)).__next__

        def k6():
            i = it()
            return decode_attention_kv_int8_cuda(q, kvq[i, 0], kvs[i, 0],
                                                 kvq[i, 1], kvs[i, 1], pos)
        deq = [(kvq[i].float() * kvs[i][..., None]).bfloat16()
               for i in range(4)]
        mask = (torch.arange(S, device="cuda")[None, :]
                <= pos[:, None])[:, None, None, :]

        def sdpa(i=None):
            i = it() % 4 if i is None else i
            return F.scaled_dot_product_attention(
                q[:, :, None], deq[i][0], deq[i][1], attn_mask=mask,
                enable_gqa=True)
        err = float((sdpa(0).reshape(B, -1).float() -
                     decode_attention_kv_int8_cuda(
                         q, kvq[0, 0], kvs[0, 0], kvq[0, 1], kvs[0, 1],
                         pos).float()).abs().max())
        t_k = time_ms(k6, n, graph=True)
        t_l = time_ms(sdpa, n, graph=True)
        b_ms, b_by = kv8_bound_ms(B, rows)
        out.append({"shape": f"K6 {label}", "ms": t_k,
                    "k5_ms": k5.get(label),
                    "sdpa_dequantized_reference_ms": t_l, "bound_ms": b_ms,
                    "bound_by": b_by, "caches": n,
                    "mb_read_a_cycle": 2 * rows * HKV * (DH + 4) * n / 1e6,
                    "sdpa_max_abs_err": err})
        del kvq, kvs, deq
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose qwen3_tts_tpu_torch to time "
                         "(default: this one)")
    sys.path.insert(0, ap.parse_args().root)
    import torch
    if not torch.cuda.is_available():
        print("bench_decode_attention: needs a CUDA device", file=sys.stderr)
        return 1
    import qwen3_tts_tpu_torch
    k5 = run()
    for row in k5 + run_paged() + run_kv_int8(k5):
        print(json.dumps({"root": qwen3_tts_tpu_torch.__path__[0], **row,
                          "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
