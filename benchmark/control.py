"""The readings that the correctness limits are set from: for each seed,
one short window of the cell at its own load, then on the same sample of
finished requests the program's numbers (its served tokens and audio
against the reference) and each control's: the reference with one part
one precision step below the configured one (int4 for int8 weights, int8
for bf16, TF32 for float32), the talker, the code predictor or the
vocoder, the others as configured. Each control is judged by the
configuration's limits, as the program is, and has to come out not
correct. All seeds in one process. One JSON line a seed; the limit of
each number lies above the program's largest reading and below the
smallest of a control that it has to fail (PERF.md gives both).

    python3 benchmark/control.py --workload <cell> --seconds 8 \\
        --seeds 11,12,13"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default=None,
                    help="the seeds that also read the control "
                         "(default: all)")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("control.py: no CUDA device", file=sys.stderr)
        return 2
    from benchmark import harness
    seeds = [int(s) for s in args.seeds.split(",")]
    ctl = (set(seeds) if args.control_seeds is None
           else {int(s) for s in args.control_seeds.split(",")})
    for seed in seeds:
        res = harness.run(args.workload, seed, args.seconds, False, ROOT,
                          time.perf_counter(), control=seed in ctl)
        print(json.dumps({"seed": seed, "correct": res["correct"],
                          "attempted": res["attempted"],
                          "failed": res["failed"],
                          "program": res["_numbers"],
                          "control": res.get("_control") or None,
                          "controls_all_fail": (
                              all(not v["correct"]
                                  for v in res["_control"].values())
                              if res.get("_control") else None)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
