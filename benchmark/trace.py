"""The traced run: spans recorded from the benchmark's own code around
the calls into the program's layers, a torch.profiler session over a
steady span of the window, and its reduction to the numbers the
per-layer metrics read. Nothing is written to disk.

Spans: ``record_function`` ranges wrapped around the program's entry
points at run time (the wrappers are removed when the run ends). The
profiler is started and stopped on the batcher's scheduler thread, at a
step boundary, because it records the ranges of the thread that starts
it. A kernel belongs to the innermost range around the host call that
launched it, found through the profiler's correlation id between a
launch and its kernel: so the ``qsplit`` kernels that K1, K2 and K3 all
launch are told apart by their caller.

``device_busy_s`` is the union of the device's kernel and copy intervals
(a frozen copy of ``device_busy_ms`` in
qwen3_tts_tpu_torch/tools/bench_e2e.py); launches count the runtime's
``cudaLaunchKernel`` and ``cudaLaunchKernelExC`` calls (its
``launches``), and besides the lower-level ``cuLaunchKernel`` and
``cuLaunchKernelEx`` calls, through which cuBLAS launches."""

from __future__ import annotations

import bisect
import importlib
import re
import threading
import time
from typing import Dict, List, Optional

# kernel launches: the runtime's cudaLaunchKernel and cudaLaunchKernelExC,
# and the lower-level cuLaunchKernel and cuLaunchKernelEx (cuBLAS's way)
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel")
RUNTIME = ("cuda", "cu")

# (module, attribute, label): the program's entry points a range wraps
ENTRY_POINTS = (
    ("qwen3_tts_tpu_torch.ops.quant", "qmatmul", "K1"),
    ("qwen3_tts_tpu_torch.ops.quant", "qmatmul_group", "K1"),
    ("qwen3_tts_tpu_torch.models.code_predictor", "cp_decode_steps", "K2"),
    ("qwen3_tts_tpu_torch.models.talker", "talker_decode_step_fused", "K3"),
    ("qwen3_tts_tpu_torch.models.transformer", "paged_decode_attention",
     "K4"),
    ("qwen3_tts_tpu_torch.models.transformer", "decode_attention", "K5"),
    ("qwen3_tts_tpu_torch.engine.generate", "run_steps", "run_steps"),
    ("qwen3_tts_tpu_torch.engine.generate", "prefill_state", "prefill"),
    ("qwen3_tts_tpu_torch.models.talker", "decode_step", "talker_step"),
    ("qwen3_tts_tpu_torch.models.talker", "codec_logits", "codec_head"),
    ("qwen3_tts_tpu_torch.models.code_predictor", "predict_codes",
     "code_predictor"),
    ("qwen3_tts_tpu_torch.ops.sampling", "sample_code0", "sample"),
    ("qwen3_tts_tpu_torch.serve.batching", "vocode", "vocode"),
)
# the batcher's own methods (on the instance)
BATCHER_METHODS = (("_admit", "admit"), ("_harvest", "harvest"))
LABELS = ({lab for _m, _a, lab in ENTRY_POINTS}
          | {lab for _a, lab in BATCHER_METHODS} | {"stream", "step"})


def _ranged(fn, label: str):
    from torch.profiler import record_function

    def wrapper(*args, **kwargs):
        with record_function(label):
            return fn(*args, **kwargs)
    wrapper.__wrapped__ = fn
    return wrapper


class Tracer:
    """Starts the profiler on the scheduler thread at the first step at or
    after ``t_on`` and stops it at the first step end at or after
    ``t_off`` (perf_counter times). The ranges are wrapped around the
    program's entry points only for that span, on the same thread, so
    the rest of the run pays nothing for them."""

    def __init__(self, batcher, t_on: float, t_off: float,
                 counters: Dict[str, object]):
        self.b, self.t_on, self.t_off = batcher, t_on, t_off
        self.counters = counters          # name -> object with .launches
        self.prof = None
        self.state = "waiting"
        self.host_s = None
        self.counts: Dict[str, int] = {}
        self.error: Optional[BaseException] = None
        self.done = threading.Event()
        self._undo: List[tuple] = []

    def attach(self) -> None:
        step = self.b.step

        def traced_step():
            self._maybe_start()
            try:
                if self.state != "on":
                    return step()
                from torch.profiler import record_function
                with record_function("step"):
                    return step()
            finally:
                self._maybe_stop()
        self.b.step = traced_step

    def detach(self) -> None:
        self._unwrap()
        self.b.__dict__.pop("step", None)

    def _wrap(self) -> None:
        for mod_name, attr, label in ENTRY_POINTS:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            self._undo.append((mod, attr, fn))
            setattr(mod, attr, _ranged(fn, label))
        b = self.b
        for attr, label in BATCHER_METHODS:
            self._undo.append((b, attr, None))
            setattr(b, attr, _ranged(getattr(b, attr), label))
        self._undo.append((b._stepper, "advance", None))
        b._stepper.advance = _ranged(b._stepper.advance, "stream")

    def _unwrap(self) -> None:
        for obj, attr, fn in reversed(self._undo):
            if fn is None:                  # an instance attribute
                obj.__dict__.pop(attr, None)
            else:
                setattr(obj, attr, fn)
        self._undo = []

    def _read_counters(self) -> Dict[str, int]:
        return {k: int(v.launches) for k, v in self.counters.items()}

    def _maybe_start(self) -> None:
        if self.state != "waiting" or time.perf_counter() < self.t_on:
            return
        from torch.profiler import ProfilerActivity, profile
        self._wrap()
        try:
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()
        except Exception as e:          # no profiler: the metrics go
            self._unwrap()
            self.error, self.state = e, "failed"
            self.done.set()
            return
        self.counts = self._read_counters()
        self._t0 = time.perf_counter()
        self.state = "on"

    def _maybe_stop(self) -> None:
        if self.state != "on" or time.perf_counter() < self.t_off:
            return
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        after = self._read_counters()
        self.counts = {k: after[k] - self.counts[k] for k in after}
        self.host_s = time.perf_counter() - self._t0
        self.prof.stop()
        self._unwrap()
        self.state = "done"
        self.done.set()


def _union(spans) -> float:
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def _merged(spans) -> List[tuple]:
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def kernel_kind(name: str) -> str:
    """A kernel name without its namespaces and argument list (a frozen
    copy of tools/bench_cp_decode.kernel_kind), cut to 60 characters."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name)
    depth, cut = 0, len(name)
    for i in range(len(name) - 1, -1, -1):
        if name[i] == ")":
            depth += 1
        elif name[i] == "(":
            depth -= 1
            if depth == 0:
                cut = i
                break
    return name[:cut].strip()[:60]


class _Ranges:
    """The ranges of one thread, properly nested, for innermost lookups:
    from the range that started last before t, up its parents."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda x: (x[0], -x[1]))
        self.starts = [s for s, _, _ in self.spans]
        self.parent: List[int] = []
        stack: List[int] = []
        for i, (s, _e, _lab) in enumerate(self.spans):
            while stack and self.spans[stack[-1]][1] < s:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def innermost(self, t: int) -> Optional[str]:
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0:
            _s, e, lab = self.spans[i]
            if e >= t:
                return lab
            i = self.parent[i]
        return None


def reduce(prof, host_s: float) -> dict:
    """The profiler session's numbers: span and busy seconds, launches,
    each label's device seconds (the union of its kernels' intervals)
    and calls, and the breakdown (device ops by label and kernel name;
    idle time by what the scheduler thread was doing)."""
    cpu_ranges: Dict[int, list] = {}
    launches: Dict[int, tuple] = {}
    dev = []
    n_launch = 0
    t_lo, t_hi = None, None
    for e in prof.profiler.kineto_results.events():
        dt = str(e.device_type())
        s, d = e.start_ns(), e.duration_ns()
        if dt.endswith("CUDA"):
            # the device's copies of the ranges are no operations
            if not (e.is_user_annotation() or e.name() in LABELS):
                dev.append((s, s + d, e.name(), e.correlation_id()))
            continue
        t_lo = s if t_lo is None else min(t_lo, s)
        t_hi = s + d if t_hi is None else max(t_hi, s + d)
        if e.is_user_annotation():
            cpu_ranges.setdefault(e.start_thread_id(), []).append(
                (s, s + d, e.name()))
        elif e.name().startswith(RUNTIME):
            # the CUDA API's calls (cuBLAS launches through cuLaunchKernel)
            # carry the correlation id of what they enqueue
            n_launch += e.name().startswith(LAUNCH_CALLS)
            launches[e.correlation_id()] = (s, e.start_thread_id())
    ranges = {tid: _Ranges(sp) for tid, sp in cpu_ranges.items()}
    calls: Dict[str, int] = {}
    for sp in cpu_ranges.values():
        for _, _, lab in sp:
            calls[lab] = calls.get(lab, 0) + 1
    by_label: Dict[str, list] = {}
    ops: Dict[str, float] = {}
    for s, e, name, corr in dev:
        hit = launches.get(corr)
        lab = None
        if hit is not None and hit[1] in ranges:
            lab = ranges[hit[1]].innermost(hit[0])
        lab = lab or "-"
        by_label.setdefault(lab, []).append((s, e))
        key = f"{lab} {kernel_kind(name)}"
        ops[key] = ops.get(key, 0.0) + (e - s) / 1e9
    busy_iv = _merged([(s, e) for s, e, _, _ in dev])
    busy_s = sum(e - s for s, e in busy_iv) / 1e9
    # idle gaps inside the span, by the scheduler thread's innermost range
    sched = max(cpu_ranges, key=lambda t: sum(1 for x in cpu_ranges[t]
                                              if x[2] == "step"),
                default=None)
    idle: Dict[str, float] = {}
    if busy_iv and sched is not None:
        edges = [(t_lo, t_lo)] + busy_iv + [(t_hi, t_hi)]
        for (_, a), (b, _) in zip(edges, edges[1:]):
            if b > a:
                lab = ranges[sched].innermost(a) or "idle"
                idle[lab] = idle.get(lab, 0.0) + (b - a) / 1e9
    top = lambda d: sorted(([k, v] for k, v in d.items()),  # noqa: E731
                           key=lambda kv: -kv[1])[:10]
    return {"span_s": host_s, "busy_s": busy_s, "launches": n_launch,
            "label_s": {k: _union(v) / 1e9 for k, v in by_label.items()},
            "label_calls": calls,
            "breakdown": {"device_ops": top(ops), "idle_gaps": top(idle)}}
