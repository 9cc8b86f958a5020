"""Tools of the port, run as ``python -m qwen3_tts_tpu_torch.tools.<name>``:
the offline tools ``convert_weights`` and ``encode_reference_audio``
(twins of the JAX package's tools/), and development probes and
benchmarks (twins of its tools/dev probes), whose progress lines go to
stderr, as the JAX tools' do."""

from __future__ import annotations

import statistics
import sys

import torch


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def log_device(dev: torch.device) -> None:
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "host"
    log(f"device: {dev} ({name})")


def sync(dev: torch.device) -> None:
    """Wait for the device, so a host clock read after it covers the
    work."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_ms(fn, iters: int, reps: int = 5, graph: bool = False) -> float:
    """Median over ``reps`` of the mean CUDA-event time of ``iters``
    back-to-back calls, after one warm-up call. ``graph=True`` captures
    the calls in a CUDA graph and times its replay: the device time of a
    call whose host side (Python, ctypes) takes longer than its kernels."""
    fn()
    torch.cuda.synchronize()
    run = lambda: [fn() for _ in range(iters)]  # noqa: E731
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            run()
        run = g.replay
        run()
        torch.cuda.synchronize()
    vals = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        run()
        e.record()
        e.synchronize()
        vals.append(s.elapsed_time(e) / iters)
    return statistics.median(vals)
