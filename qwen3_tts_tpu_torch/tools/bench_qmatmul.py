"""Time K1 (the weight-only int8 matmul, ops/kernels/qmatmul.py) on one
NVIDIA GPU at the shapes the slice gives it: codec_head at one row, the
code predictor's 2-token prefill products at R = 2 and 8 (q|k|v and
gate|up as the groups that share their rows, down alone), and the talker
prefill's four products (q|k|v, o, gate|up, down) at the slice's R = 41
prefix rows and the largest text bucket's 265, q|k|v at 73 too, and at
the 128 rows of a chunked-prefill window (talker.prefill_chunked).

Each case is timed as a decode step meets it, with weights from HBM: the
calls take in turn copies of the case's weights that together exceed the
50 MB L2; the calls are captured in a CUDA graph and replayed, so the
time is device time. A group goes through ``qmatmul_group`` where the
checkout has it (one launch for decode rows), else through one
``qmatmul`` call a weight, as that checkout's transformer calls them.

    python -m qwen3_tts_tpu_torch.tools.bench_qmatmul
    python qwen3_tts_tpu_torch/tools/bench_qmatmul.py --root DIR

``--root DIR`` imports qwen3_tts_tpu_torch from another checkout of the
repository (its kernels are built there), so two versions of K1 can be
timed in turns on one card. Each case also carries its bound: the larger
of its bytes (x, weights and scales read once, the output written once)
over 3.35 TB/s and its operations over the 989 TFLOP/s of bf16 (H100
SXM, published). ``--library`` adds, for the cases past 8 rows, the time
of ``torch._weight_int8pack_mm`` on the same inputs (the library's
weight-only int8 product; a yardstick the port never calls) and, for
reference, of cuBLAS over the weight dequantized to bf16. Prints one
JSON line per case.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
from pathlib import Path

# (label, M, K, Ns): the weights of a case share its M rows
CASES = (("codec_head", 1, 1024, [3072]),
         ("cp prefill q|k|v R=2", 2, 1024, [2048, 1024, 1024]),
         ("cp prefill gate|up R=2", 2, 1024, [3072, 3072]),
         ("cp prefill down R=2", 2, 3072, [1024]),
         ("cp prefill q|k|v R=8", 8, 1024, [2048, 1024, 1024]),
         ("cp prefill gate|up R=8", 8, 1024, [3072, 3072]),
         ("talker prefill q|k|v R=41", 41, 1024, [4096]),
         ("talker prefill o R=41", 41, 2048, [1024]),
         ("talker prefill gate|up R=41", 41, 1024, [6144]),
         ("talker prefill down R=41", 41, 3072, [1024]),
         ("talker prefill q|k|v R=73", 73, 1024, [4096]),
         ("talker prefill q|k|v R=265", 265, 1024, [4096]),
         ("talker prefill o R=265", 265, 2048, [1024]),
         ("talker prefill gate|up R=265", 265, 1024, [6144]),
         ("talker prefill down R=265", 265, 3072, [1024]),
         ("talker chunked prefill q|k|v R=128", 128, 1024, [4096]),
         ("talker chunked prefill o R=128", 128, 2048, [1024]),
         ("talker chunked prefill gate|up R=128", 128, 1024, [6144]),
         ("talker chunked prefill down R=128", 128, 3072, [1024]))
SEED = 1
L2_COPIES_BYTES = 64 << 20     # more than the 50 MB L2 (H100 SXM)
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, published
BF16_FLOPS = 989e12            # dense bf16 tensor cores, published


def bound(M: int, K: int, Ns) -> tuple:
    """(ms, "bytes" or "operations"): the least time of a case on the
    card, x in bf16 and the output in f32."""
    n_bytes = M * K * 2 + sum(K * N + 4 * N + 4 * M * N for N in Ns)
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = 2.0 * M * K * sum(Ns) / BF16_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def inputs(g, M, K, Ns):
    """x (M, K) bf16 and [(q (K, N) int8, scale (N,) f32)] on the card."""
    import torch
    x = torch.randn((M, K), generator=g, device="cuda").bfloat16()
    ws = [(torch.randint(-127, 128, (K, N), generator=g, device="cuda",
                         dtype=torch.int8),
           torch.rand((N,), generator=g, device="cuda") * 0.01 + 1e-3)
          for N in Ns]
    return x, ws


def _cycled(ts, nbytes):
    """A callable handing out ``ts`` and copies of it, together more than
    the L2, in turn."""
    copies = [ts] + [[t.clone() for t in ts]
                     for _ in range(L2_COPIES_BYTES // nbytes)]
    return itertools.cycle(copies).__next__


def library_ms(x, q, s):
    """(ms of torch._weight_int8pack_mm on x and q (K, N) as its (N, K)
    layout with bf16 scales, or None where this torch has no CUDA kernel
    for the shape; ms of cuBLAS over q dequantized to bf16), weights from
    HBM. Yardsticks only: the port calls neither."""
    import torch
    from qwen3_tts_tpu_torch.tools import time_ms
    K, N = q.shape
    xb = x.bfloat16()
    nxt = _cycled([q.T.contiguous()], K * N)
    s16 = s.bfloat16()
    try:
        lib = time_ms(lambda: torch._weight_int8pack_mm(xb, nxt()[0], s16),
                      50, graph=True)
    except (RuntimeError, NotImplementedError):
        lib = None
    nxt = _cycled([(q.float() * s).bfloat16()], 2 * K * N)
    dense = time_ms(lambda: xb @ nxt()[0], 50, graph=True)
    return lib, dense


def run(library: bool = False) -> list:
    """Time each case; returns one dict per case: device ms of the
    group, K1 launches a call, the int8 weight rate, the bound and (with
    ``library``, past 8 rows) the library's times."""
    import torch
    from qwen3_tts_tpu_torch.ops.kernels import qmatmul as tqm
    from qwen3_tts_tpu_torch.tools import time_ms
    group = getattr(tqm, "qmatmul_group", None)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    out = []
    for label, M, K, Ns in CASES:
        x, ws = inputs(g, M, K, Ns)
        if group is not None:
            call = lambda w: group(x, w)        # noqa: E731
        else:
            call = lambda w: [tqm.qmatmul(x, q, s) for q, s in w]  # noqa: E731
        n0 = tqm.qmatmul.launches
        call(ws)
        launches = tqm.qmatmul.launches - n0
        wbytes = K * sum(Ns)
        copies = [ws] + [[(q.clone(), s) for q, s in ws]
                         for _ in range(L2_COPIES_BYTES // wbytes)]
        nxt = itertools.cycle(copies).__next__
        t = time_ms(lambda: call(nxt()), 50, graph=True)
        del copies
        b_ms, b_by = bound(M, K, Ns)
        row = {"case": label, "M": M, "K": K, "Ns": Ns, "ms": t,
               "launches_a_call": launches,
               "weight_gb_s": wbytes / (t * 1e-3) / 1e9,
               "bound_ms": b_ms, "bound_by": b_by}
        if library and M > 8 and len(Ns) == 1:
            row["library_ms"], row["cublas_bf16_ms"] = library_ms(
                x, *ws[0])
        out.append(row)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose qwen3_tts_tpu_torch to time "
                         "(default: this one)")
    ap.add_argument("--library", action="store_true",
                    help="also time torch._weight_int8pack_mm and cuBLAS "
                         "over the dequantized weight past 8 rows")
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import torch
    if not torch.cuda.is_available():
        print("bench_qmatmul: needs a CUDA device", file=sys.stderr)
        return 1
    import qwen3_tts_tpu_torch
    for row in run(args.library):
        print(json.dumps({"root": qwen3_tts_tpu_torch.__path__[0], **row,
                          "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
