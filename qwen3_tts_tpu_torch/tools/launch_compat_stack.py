"""Launch the reference-protocol compatibility stack (serve/compat.py):
the talker, code predictor and vocoder sockets, polled until each
accepts a connection; then one synthesis through them
(tools/reference_client.py), or, with --daemon, stay resident. Twin of
tools/launch_compat_stack.py, with the reference launcher's environment
variables:

  TALKER_SOCKET / CP_SOCKET / VOC_SOCKET, TEMPERATURE, TOP_K, MAX_TOKENS,
  LANGUAGE

Usage (the card by default):
  python -m qwen3_tts_tpu_torch.tools.launch_compat_stack "Привет!"
  python -m qwen3_tts_tpu_torch.tools.launch_compat_stack --daemon
  python -m qwen3_tts_tpu_torch.tools.launch_compat_stack --tiny \\
      --device cpu "test"
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import signal
import socket
import sys
import time


def _wait_connectable(path: str, deadline: float) -> bool:
    while time.time() < deadline:
        if os.path.exists(path):
            probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            try:
                probe.connect(path)
                return True
            except OSError:
                pass
            finally:
                probe.close()
        time.sleep(0.1)
    return False


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("text", nargs="?", default=None)
    p.add_argument("--daemon", action="store_true")
    p.add_argument("--model_dir", default=None)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--output", default="output.wav")
    args = p.parse_args(argv)

    import torch

    from qwen3_tts_tpu_torch.config import TTSConfig, tiny_tts_config
    from qwen3_tts_tpu_torch.io import weights as weights_io
    from qwen3_tts_tpu_torch.io.tokenizer import load_tokenizer
    from qwen3_tts_tpu_torch.serve import compat
    from qwen3_tts_tpu_torch.tools.reference_client import (
        synthesize_via_sockets)

    cfg = tiny_tts_config(max_tokens=32) if args.tiny else TTSConfig()
    sampling = dataclasses.replace(
        cfg.sampling,
        temperature=float(os.environ.get("TEMPERATURE",
                                         cfg.sampling.temperature)),
        top_k=int(os.environ.get("TOP_K", cfg.sampling.top_k)))
    cfg = dataclasses.replace(
        cfg, sampling=sampling,
        max_tokens=int(os.environ.get("MAX_TOKENS", cfg.max_tokens)))
    language = os.environ.get("LANGUAGE", "russian")
    socks = (os.environ.get("TALKER_SOCKET", "/tmp/qwen3_talker.sock"),
             os.environ.get("CP_SOCKET", "/tmp/qwen3_cp.sock"),
             os.environ.get("VOC_SOCKET", "/tmp/qwen3_voc.sock"))

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    print("Loading parameters...")
    params = weights_io.load_params(args.model_dir, cfg, dtype,
                                    device=args.device)
    tokenizer = load_tokenizer(args.model_dir)

    print("Starting protocol servers...")
    # a stale socket file of an earlier run would pass the poll below
    for sp in socks:
        if os.path.exists(sp):
            os.unlink(sp)
    servers, threads = compat.launch_all(params, cfg, tokenizer, *socks,
                                         device=args.device)
    deadline = time.time() + 30
    for sp in socks:
        if not _wait_connectable(sp, deadline):
            print(f"ERROR: socket {sp} never became connectable")
            return 1
        print(f"  ready: {sp}")

    def cleanup(*_):
        for s in servers:
            s.stop()
        sys.exit(0)

    signal.signal(signal.SIGINT, cleanup)
    signal.signal(signal.SIGTERM, cleanup)

    if args.daemon:
        print("Daemon mode; Ctrl-C to stop.")
        # a dead server thread ends the process with an error
        while all(t.is_alive() for t in threads):
            time.sleep(1)
        print("ERROR: a protocol server thread died; exiting")
        for s in servers:
            s.stop()
        return 1

    text = args.text or "Привет, как дела? Сегодня хорошая погода для прогулки."
    print(f"Single-shot synthesis: '{text[:50]}'")
    rc = synthesize_via_sockets(text, language, args.output, params, *socks)
    for s in servers:
        s.stop()
    return rc


if __name__ == "__main__":
    sys.exit(main())
