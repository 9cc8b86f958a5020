"""Development tools of the port: twins of the JAX package's tools/dev
probes, run as ``python -m qwen3_tts_tpu_torch.tools.<name>``. Their
progress lines go to stderr, as the JAX tools' do."""

from __future__ import annotations

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
