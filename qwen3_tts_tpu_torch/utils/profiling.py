"""Device tracing for the command line's ``--profile`` (twin of
qwen3_tts_tpu/utils/profiling.py's ``device_trace``), and the stage
timer of the engine's requests and of checkpoint loading."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def stage(timings: Dict[str, float], name: str):
    """Adds the wall seconds of the block to timings[name]."""
    t = time.perf_counter()
    try:
        yield
    finally:
        timings[name] = timings.get(name, 0.0) + time.perf_counter() - t


@contextlib.contextmanager
def device_trace(log_dir: Optional[str], device="cuda"):
    """A torch.profiler session around the block, with CUDA activity when
    ``device`` is a GPU, exported as a Chrome trace into ``log_dir``
    (``trace_<pid>.json``). Does nothing when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace_{os.getpid()}.json"))
