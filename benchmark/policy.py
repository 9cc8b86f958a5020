"""What the greedy policy of the configurations leaves off the path: the
cell run with its configured sampling (greedy) and with the port's
default, published policy (code 0 at temperature 0.8, top-k 50, top-p
0.95; groups at temperature 0.1, top-k 50), in turns, greedy / sampled /
sampled / greedy, one process. Each run is traced after its window (no
check: sampled tokens are not the reference's argmax) and prints one
JSON line: the cell's end-to-end metrics from the window, and from the
traced span the launches and the wall and device milliseconds of a loop
step (a loop step is one call of K2).

    python3 benchmark/policy.py --workload <cell> --seed <n> --seconds 20"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("policy.py: no CUDA device", file=sys.stderr)
        return 2
    from benchmark import harness
    from qwen3_tts_tpu_torch.config import SamplingConfig
    c = harness.cell(ROOT, args.workload)
    default = SamplingConfig()
    sampled = dict(c["config"]["sampling"], temperature=default.temperature,
                   top_k=default.top_k, top_p=default.top_p,
                   cp_temperature=default.cp_temperature,
                   cp_top_k=default.cp_top_k)
    t_start = T_START
    for i, policy in enumerate(("greedy", "sampled", "sampled", "greedy")):
        res = harness.run(
            args.workload, args.seed + i, args.seconds, True, ROOT, t_start,
            check=False, config_changes=(
                {"sampling": sampled} if policy == "sampled" else None))
        t_start = time.perf_counter()
        rec = res["_record"]
        out = {"policy": policy, "seed": args.seed + i,
               "attempted": res["attempted"], "failed": res["failed"]}
        for e in c["end_to_end"]:
            out[e["name"]] = harness.metric_module(
                c["bench"], e["name"]).read(rec)
        t = rec["trace"]
        steps = (t or {}).get("counts", {}).get("K2")
        if steps:
            out.update(loop_steps=steps,
                       launches_per_step=t["launches"] / steps,
                       step_ms=1e3 * t["span_s"] / steps,
                       device_ms_per_step=1e3 * t["busy_s"] / steps)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
