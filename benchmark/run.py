"""The benchmark of the PyTorch port (qwen3_tts_tpu_torch) on NVIDIA
cards: runs one cell of BENCHMARK.json once and prints one JSON line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics, read from a profiled span of the window. Every run
checks the served tokens and audio of a sample of its requests against
the plain reference (benchmark/reference/) and prints each number it
compared beside its limit, last on standard error and last in the line.
Exits 2 without a result when no CUDA card is there, 3 when a JAX
module was loaded, 1 on any other failure."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # kernel caches at fixed paths inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
    sys.path.insert(0, str(ROOT))
    try:
        from benchmark import harness
        entry = harness.cell(ROOT, args.workload)["workload"]
        import torch
        if not torch.cuda.is_available():
            print("run.py: no CUDA device", file=sys.stderr)
            return 2
        if torch.cuda.device_count() < int(entry["chips"]):
            print(f"run.py: {torch.cuda.device_count()} CUDA devices, the "
                  f"cell asks for {entry['chips']}", file=sys.stderr)
            return 2
        result = harness.run(args.workload, args.seed, args.seconds,
                             bool(args.trace), ROOT, T_START)
    except harness.Refused as e:
        print(f"run.py: {e}", file=sys.stderr)
        return 3
    except Exception:
        traceback.print_exc()
        return 1
    for k in [k for k in result if k.startswith("_")]:
        result.pop(k)
    for k, v in result.get("compared", {}).items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
