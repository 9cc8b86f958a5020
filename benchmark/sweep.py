"""The knee of an open-loop cell: the cell's traffic at each of a few
fixed rates, one window each, in one process. For each rate it prints
one JSON line: requests due and failed, the first-audio p50 and p85,
the admission wait p85, and the backlog's trend: the median admission
wait of the window's last third of requests minus that of its first
third, and the requests due in the window still unadmitted when it
closed. The knee is the highest rate whose backlog does not grow; the
cell's traffic file is then set at 0.8 x the knee.

    python3 benchmark/sweep.py --workload <cell> --seed <n> \\
        --seconds <s> --rates 1.0,1.5,2.0"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def backlog(rec: dict) -> dict:
    from benchmark import records
    due = sorted(records.due_in_window(rec), key=lambda r: r["due"])
    third = max(1, len(due) // 3)

    def wait(rs):
        w = [r["admit"] - r["due"] for r in rs if r["admit"] is not None]
        return statistics.median(w) if w else None
    head, tail = wait(due[:third]), wait(due[-third:])
    return {"admit_wait_first_third_s": head, "admit_wait_last_third_s": tail,
            "trend_s": (tail - head) if head is not None and tail is not None
            else None,
            "unadmitted_at_close": sum(1 for r in due if r["admit"] is None
                                       or r["admit"] > rec["seconds"])}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("sweep.py: no CUDA device", file=sys.stderr)
        return 2
    from benchmark import harness, records
    for rate in [float(x) for x in args.rates.split(",")]:
        res = harness.run(args.workload, args.seed, args.seconds, False,
                          ROOT, time.perf_counter(), check=False,
                          traffic_changes={"rate_per_s": rate})
        rec = res.pop("_record")
        out = {"rate_per_s": rate, "attempted": res["attempted"],
               "failed": res["failed"],
               "first_audio_p50_s": records.percentile(
                   records.latencies(rec, "due", "first"), 50),
               "first_audio_p85_s": records.percentile(
                   records.latencies(rec, "due", "first"), 85),
               "admit_wait_p85_s": records.percentile(
                   records.latencies(rec, "due", "admit"), 85),
               **backlog(rec)}
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
