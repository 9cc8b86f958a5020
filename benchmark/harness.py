"""One run of one cell: set-up, the measured window, the traced span, the
check against the reference, the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is found by name: ``BENCHMARK.json`` names a cell's configuration
and traffic; ``configs/<config>.json`` holds the configuration as it is
run (shapes, precision, the batcher's settings, the correctness limits);
``traffic/<mix>.json`` holds a generator kind's parameters and the
serving settings of that mix, the kind being ``traffic/kinds/<kind>.py``;
``metrics/<metric>.py`` reads one metric from a run's record.

The program under test is the PyTorch port, driven through its batcher's
public surface as the daemon's batched mode drives it: a
``ContinuousBatcher`` on one card, ``start()``, ``submit`` from the
traffic's client threads (streaming through ``on_chunk`` or not),
``stop()``."""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import subprocess
import sys
import threading
import time
from concurrent.futures import CancelledError
from pathlib import Path
from typing import List

BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "qwen3_tts_tpu")
TRACE_SPAN_S = 1.0        # profiled seconds asked of a traced run
TRACE_LEAD_S = 5.0        # from the window's close to the profiled span
SAMPLE_REQUESTS = 6       # finished requests the reference checks, at least,
SAMPLE_TOKENS = 1500      # and at least this many served tokens among them
DRAIN_S = 60.0            # a request due in the window may finish this late
SAMPLES_PER_S = 24000
# the text buckets the daemon pads prompts to (engine._TEXT_BUCKETS)
TEXT_BUCKETS = (16, 32, 64, 128, 256)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Refused(RuntimeError):
    """The run cannot give a result (no card, a forbidden module)."""


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, str(path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def manifest(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(root: Path, name: str) -> dict:
    """The cell's manifest entry with its configuration, traffic and
    metric entries resolved by name."""
    m = manifest(root)
    cells = {w["name"]: w for w in m["workloads"]}
    if name not in cells:
        raise ValueError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = {c["name"]: c for c in m["configs"]}[w["config"]]
    bench = root / conf["file"].split("/")[0]
    traffic = json.loads((bench / "traffic" / f"{w['traffic']}.json")
                         .read_text())

    def mine(entries):
        return [e for e in entries if name in e.get("workloads", [name])]
    return {"name": name, "workload": w, "config_entry": conf,
            "config": json.loads((root / conf["file"]).read_text()),
            "traffic": traffic, "bench": bench,
            "end_to_end": mine(m["end_to_end"]),
            "per_layer": mine(m["per_layer"])}


def metric_module(bench: Path, name: str):
    """metrics/<name>.py, or else the reader of the name before its first
    dot (``mfu_pct`` serves ``mfu_pct.stream``: a quantity split by the
    end-to-end metric that BENCHMARK.json says it moves)."""
    path = bench / "metrics" / f"{name}.py"
    if not path.exists():
        path = bench / "metrics" / f"{name.split('.')[0]}.py"
    return load_module(path, "benchmark_metric_" + name.replace(".", "_")
                       .replace("-", "_"))


def kind_module(bench: Path, kind: str):
    return load_module(bench / "traffic" / "kinds" / f"{kind}.py",
                       "benchmark_kind_" + kind)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def port_config(cfg: dict):
    from qwen3_tts_tpu_torch import config as C
    v = dict(cfg["vocoder"])
    for k in ("upsampling_ratios", "upsample_rates"):
        v[k] = tuple(v[k])
    return C.TTSConfig(talker=C.TalkerConfig(**cfg["talker"]),
                       code_predictor=C.CodePredictorConfig(
                           **cfg["code_predictor"]),
                       vocoder=C.VocoderConfig(**v),
                       sampling=C.SamplingConfig(**cfg["sampling"]),
                       max_tokens=int(cfg["max_tokens"]))


def padded_ids(ids):
    import numpy as np
    n = len(ids)
    b = next((b for b in TEXT_BUCKETS if n <= b), TEXT_BUCKETS[-1])
    out = np.zeros((b,), np.int32)
    out[:n] = ids
    return out


def build_batcher(cfg: dict, traffic: dict, weights: dict, device):
    import torch
    from qwen3_tts_tpu_torch.serve.batching import ContinuousBatcher
    bc = dict(cfg["batcher"])
    return ContinuousBatcher(
        port_config(cfg), weights, batch_size=int(bc.pop("batch_size")),
        decode_chunk=int(traffic["decode_chunk"]), dtype=torch.bfloat16,
        device=device, **bc)


class Client:
    """The requests a run sends, each with its times: ``due`` (scheduled
    send), ``sent``, ``first`` (first on_chunk call) on the perf_counter
    clock, the port's ``t_admit``/``t_done`` read after the run."""

    def __init__(self, batcher):
        self.b = batcher
        self.records: List[dict] = []
        self.lock = threading.Lock()

    def submit(self, spec: dict, due: float):
        rec = {"spec": spec, "due": due, "sent": time.perf_counter(),
               "first": None, "parts": []}

        def on_chunk(part):
            if rec["first"] is None:
                rec["first"] = time.perf_counter()
            rec["parts"].append(part)
        fut = self.b.submit(padded_ids(spec["ids"]), spec["n_text"],
                            seed=spec["seed"],
                            on_chunk=on_chunk if spec["stream"] else None)
        rec["future"] = fut
        with self.lock:
            self.records.append(rec)
        return fut


def warm_up(b, plan: list, vocoder_weights: dict, max_tokens: int,
            timeout: float = 300.0) -> None:
    """Reach every shape the cell's traffic reaches before the window: one
    full batch of short requests (at most 64 tokens) with text lengths
    spread over the plan's range, so every text bucket's prefill runs,
    streaming as the traffic streams (the stream's quanta); then the
    vocoder once at each whole-request window up to max_tokens + 1
    tokens, through the program's own ``vocode`` on the same weights."""
    import numpy as np
    from qwen3_tts_tpu_torch.engine.engine import vocode
    lens = sorted({r["n_text"] for r in plan})
    B = b.batch_size
    stream = any(r["stream"] for r in plan)
    futs = []
    for i in range(B):
        n = lens[max(0, len(lens) - 1 - (i * len(lens)) // B)]
        ids = plan[i % len(plan)]["ids"]
        ids = (list(ids) * (n // max(len(ids), 1) + 1))[:n]
        futs.append(b.submit(padded_ids(ids), n, seed=i,
                             max_tokens=max(9, 64 * (B - i) // B),
                             on_chunk=(lambda part: None) if stream
                             else None))
    for f in futs:
        f.result(timeout=timeout)
    if not stream:
        for w in range(64, max_tokens + 1 + 64, 64):
            vocode(vocoder_weights, np.zeros((w - 1, 16), np.int32),
                   b.cfg.vocoder, b.device)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run(workload: str, seed: int, seconds: float, trace: bool,
        root: Path, t_start: float, device: str = "cuda",
        check: bool = True, traffic_changes=None, config_changes=None,
        control: bool = False) -> dict:
    """Run ``workload`` once; returns the result line's dict and, under
    keys that start with ``_``, the record and every number read.
    ``traffic_changes`` replaces parameters of the cell's traffic (the
    knee sweep's rates), ``config_changes`` top-level keys of its
    configuration (policy.py's sampling); ``control`` also reads each control's numbers on
    the same sample and judges them by the same limits (``_control``).
    Raises Refused when a JAX module was loaded by then."""
    import numpy as np
    import torch

    from benchmark import weights as W
    c = cell(root, workload)
    cfg = {**c["config"], **(config_changes or {})}
    traffic = {**c["traffic"], **(traffic_changes or {})}
    kind = kind_module(c["bench"], traffic["kind"])
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    marks = [("imports", time.perf_counter())]
    params = W.make(cfg, seed, dev)
    marks.append(("weights", time.perf_counter()))
    b = build_batcher(cfg, traffic, params, dev)
    marks.append(("batcher", time.perf_counter()))
    plan = kind.plan(traffic, seed, seconds)
    b.start()
    warm_up(b, plan, params["vocoder"], int(cfg["max_tokens"]))
    marks.append(("warm-up", time.perf_counter()))
    log("set-up s: " + ", ".join(
        f"{name} {t - prev:.2f}" for (name, t), prev in
        zip(marks, [t_start] + [t for _, t in marks[:-1]])))
    tracer = None
    if trace:
        from benchmark import trace as T
        from qwen3_tts_tpu_torch.ops.kernels import (cp_decode, paged_attention,
                                                     talker_step)
        tracer = T.Tracer(b, math.inf, math.inf, {
            "K2": cp_decode.cp_decode_steps,
            "K3": talker_step.talker_decode_step_fused,
            "K4": paged_attention.paged_decode_attention})
        tracer.attach()
        # the load goes on past the window for the profiled span, so that
        # the window's requests are served untraced: open-loop arrivals
        # continue on a schedule of their own, closed-loop clients keep
        # sending
        extra = TRACE_LEAD_S + 4 * TRACE_SPAN_S + 30.0
        plan = plan + [dict(r, due=r["due"] + seconds)
                       for r in kind.plan(traffic, seed + 1, extra)
                       if r["due"] is not None]
    if dev.type == "cuda":
        torch.cuda.synchronize()
    client = Client(b)
    stop = threading.Event()
    t0 = time.perf_counter() + 0.05
    t_end = t0 + seconds
    setup_s = t0 - t_start
    if tracer is not None:
        tracer.t_on = t_end + TRACE_LEAD_S
        tracer.t_off = tracer.t_on + TRACE_SPAN_S
    drive_end = t_end if tracer is None else t_end + extra
    threads = kind.drive(plan, client.submit, t0, drive_end, stop)
    time.sleep(max(0.0, t_end - time.perf_counter()))
    if tracer is not None:
        tracer.done.wait(timeout=max(0.0, drive_end - time.perf_counter()))
    stop.set()
    # requests due in the window may finish up to DRAIN_S late
    deadline = t_end + DRAIN_S
    with client.lock:
        due = list(client.records)
    for r in due:
        try:
            r["future"].exception(timeout=max(0.0, deadline
                                              - time.perf_counter()))
        except (TimeoutError, CancelledError):
            pass
    b.stop(drain=True, timeout=max(1.0, deadline - time.perf_counter()))
    for t in threads:
        t.join(timeout=10.0)
    if tracer is not None:
        tracer.detach()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)

    # the record every metric reads
    reqs = []
    for r in client.records:
        fut = r["future"]
        req = getattr(fut, "request", None)
        ok = fut.done() and not fut.cancelled() and fut.exception(
            timeout=0) is None
        codes, audio = fut.result(timeout=0) if ok else (None, None)
        first = r["first"]
        if ok and r["spec"]["stream"]:
            audio = (np.concatenate(r["parts"]) if r["parts"]
                     else np.zeros((0,), np.int16))
        done_t = req.t_done if req is not None else None
        late = done_t is None or done_t > deadline
        reqs.append({
            "due": r["due"] - t0, "sent": r["sent"] - t0,
            "admit": (req.t_admit - t0) if req is not None and
            req.t_admit is not None else None,
            "first": (first - t0) if first is not None else None,
            "done": (done_t - t0) if done_t is not None else None,
            "n_text": r["spec"]["n_text"], "stream": r["spec"]["stream"],
            "failed": (not ok) or late or (r["spec"]["stream"]
                                           and first is None),
            "n_codes": len(codes) if ok else 0,
            "audio_s": len(audio) / SAMPLES_PER_S if ok else 0.0,
            "_ids": r["spec"]["ids"], "_codes": codes, "_audio": audio})
    rec = {"cell": workload, "config": cfg, "traffic": traffic,
           "seconds": seconds, "setup_s": setup_s,
           "batch_size": b.batch_size, "requests": reqs,
           "max_pages": getattr(b, "max_pages_per_slot", 0), "trace": None}
    if tracer is not None and tracer.state == "done":
        from benchmark import trace as T
        red = T.reduce(tracer.prof, tracer.host_s)
        red["counts"] = tracer.counts
        red["power"] = power_limit() if dev.type == "cuda" else "host"
        log(f"trace: card and power.limit {red['power']}")
        rec["trace"] = red
        tracer.prof = None
    elif tracer is not None:
        log(f"trace: the profiler did not cover a span ({tracer.state}, "
            f"{tracer.error!r})")

    # free the program's state before the reference runs
    del b
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    names = [e["name"] for e in (c["per_layer"] if trace
                                 else c["end_to_end"])]
    metrics = {}
    for name in names:
        mod = metric_module(c["bench"], name)
        val = mod.read(rec)
        if val is not None:
            metrics[name] = {"value": val, "unit": mod.UNIT}
    in_window = [r for r in reqs if r["due"] < seconds]
    result = {"correct": None, "attempted": len(in_window),
              "failed": sum(r["failed"] for r in in_window),
              "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                         "kind": (torch.cuda.get_device_name(dev)
                                  if dev.type == "cuda" else "host"),
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if rec["trace"] is not None:
        result["device"]["busy_s"] = rec["trace"]["busy_s"]
        result["device"]["window_s"] = rec["trace"]["span_s"]
        result["breakdown"] = rec["trace"]["breakdown"]
    from benchmark.reference import check as ref_check
    if check or control:
        t_ref = time.perf_counter()
        readings, limits = correctness(
            cfg, params, reqs, seed, dev,
            ref_check.CONTROLS if control else ())
        log(f"reference: {time.perf_counter() - t_ref:.2f} s")
        numbers = readings.pop("program")
        result["correct"] = (ref_check.judge(numbers, limits)
                             and result["failed"] == 0)
        result["_numbers"] = numbers
        # each control in the program's place, judged by the same limits
        result["_control"] = {
            k: dict(v, correct=ref_check.judge(v, limits))
            for k, v in readings.items()}
        result["compared"] = {k: {"value": numbers[k], "limit": limits[k]}
                              for k in limits}
    result["_record"] = rec
    # last: whatever the metrics, the reference or the program loaded
    found = forbidden_modules()
    if found:
        raise Refused(f"forbidden modules loaded: {', '.join(found)}")
    return result


def sample(reqs: List[dict], seed: int) -> list:
    """Finished requests for the check, drawn from the seed: the longest,
    then others in the seed's order until there are SAMPLE_REQUESTS of
    them holding SAMPLE_TOKENS served tokens (or no more)."""
    from benchmark import gen
    done = [r for r in reqs if not r["failed"] and r["_codes"] is not None]
    if not done:
        return []
    longest = max(range(len(done)), key=lambda i: done[i]["n_codes"])
    rest = [i for i in range(len(done)) if i != longest]
    order = [longest] + [rest[i] for i in gen.rng(seed, 3).permutation(
        len(rest))]
    pick, tokens = [], 0
    for i in order:
        if len(pick) >= SAMPLE_REQUESTS and tokens >= SAMPLE_TOKENS:
            break
        pick.append(i)
        tokens += done[i]["n_codes"]
    return [{"ids": done[i]["_ids"], "codes": done[i]["_codes"],
             "audio": done[i]["_audio"]} for i in pick]


def correctness(cfg: dict, params: dict, reqs: List[dict], seed: int,
                dev, controls=()) -> tuple:
    """(readings, limits): the program's numbers over the sampled requests
    against the reference under ``"program"``, and each control's under
    its name; no finished request reads every number infinite."""
    from benchmark.reference import check
    chosen = sample(reqs, seed)
    limits = {k: float(v) for k, v in cfg["limits"].items()}
    if not chosen:
        return {k: {n: math.inf for n in limits}
                for k in ("program",) + tuple(controls)}, limits
    return check.readings(cfg, params, chosen, dev, controls), limits
