"""Whether a torch.profiler session slows the kernels that a process runs
after it, on one NVIDIA GPU: the CUDA-graph replay time of K2 (B = 1, the
14 steps, a chain of 392 dependent launches), K3 (B = 1, pos 490, a chain
of 142) and K1 (one qmatmul launch, (1, 1024) x (1024, 3072), no chain),
before any profiler session, after one and after four (each session
profiles three K3 calls, as tools/bench_talker_step does).

    python -m qwen3_tts_tpu_torch.tools.bench_profiler_residue

Prints one JSON line: the ms of each kernel, twice at each point. On an
H100 the two chains replayed a few percent slower after the first
session, which is why bench_cp_decode, bench_talker_step and
chip_smoke.py time every case before they profile any.
"""

from __future__ import annotations

import json
import sys


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("bench_profiler_residue: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from qwen3_tts_tpu_torch.ops.kernels.qmatmul import qmatmul
    from qwen3_tts_tpu_torch.tools import (bench_cp_decode, bench_talker_step,
                                           time_ms)
    cfg2, cp = bench_cp_decode.cp_params()
    cfg3, layers = bench_talker_step.talker_layers()
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((1, 1024), generator=g, device="cuda").bfloat16()
    q = torch.randint(-127, 128, (1024, 3072), generator=g, device="cuda",
                      dtype=torch.int8)
    s = torch.rand((3072,), generator=g, device="cuda") * 0.01 + 1e-3
    calls = {"K2": bench_cp_decode.k2_call(cfg2, cp, 1),
             "K3": bench_talker_step.k3_call(cfg3, layers, [490],
                                             bench_talker_step.SEED),
             "K1": lambda: qmatmul(x, q, s)}

    def times():
        return {k: [time_ms(f, 10, graph=True) for _ in range(2)]
                for k, f in calls.items()}
    out = {"before any profile": times()}
    sessions = 0
    for n in (1, 4):
        while sessions < n:
            bench_cp_decode.profile_call(calls["K3"])
            sessions += 1
        out[f"after {n} profiles"] = times()
    print(json.dumps({"ms": out, "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
