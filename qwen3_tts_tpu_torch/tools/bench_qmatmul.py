"""Time K1 (the weight-only int8 matmul, ops/kernels/qmatmul.py) on one
NVIDIA GPU at the shapes the slice gives it: codec_head at one row, the
code predictor's 2-token prefill products at R = 2 and 8 (q|k|v and
gate|up as the groups that share their rows, down alone), and the talker
prefill's q|k|v at R = 73 and 265 prefix rows.

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
timed in turns on one card. Prints one JSON line per case.
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
         ("talker prefill q|k|v R=73", 73, 1024, [4096]),
         ("talker prefill q|k|v R=265", 265, 1024, [4096]))
SEED = 1
L2_COPIES_BYTES = 64 << 20     # more than the 50 MB L2 (H100 SXM)


def inputs(g, M, K, Ns):
    """x (M, K) bf16 and [(q (K, N) int8, scale (N,) f32)] on the card."""
    import torch
    x = torch.randn((M, K), generator=g, device="cuda").bfloat16()
    ws = [(torch.randint(-127, 128, (K, N), generator=g, device="cuda",
                         dtype=torch.int8),
           torch.rand((N,), generator=g, device="cuda") * 0.01 + 1e-3)
          for N in Ns]
    return x, ws


def run() -> list:
    """Time each case; returns one dict per case: device ms of the
    group, K1 launches a call, the int8 weight rate."""
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
        out.append({"case": label, "M": M, "K": K, "Ns": Ns, "ms": t,
                    "launches_a_call": launches,
                    "weight_gb_s": wbytes / (t * 1e-3) / 1e9})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose qwen3_tts_tpu_torch to time "
                         "(default: this one)")
    sys.path.insert(0, ap.parse_args().root)
    import torch
    if not torch.cuda.is_available():
        print("bench_qmatmul: needs a CUDA device", file=sys.stderr)
        return 1
    import qwen3_tts_tpu_torch
    for row in run():
        print(json.dumps({"root": qwen3_tts_tpu_torch.__path__[0], **row,
                          "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
