"""Device tracing for the command line's ``--profile``. Twin of
qwen3_tts_tpu/utils/profiling.py's ``device_trace`` (the engine times its
stages itself, engine._stage)."""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch


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
