"""Serving soak of the port: sustained mixed load on the continuous
batcher (the daemon's ``--batch`` tier). Twin of the JAX package's
tools/dev/soak_daemon.py.

    python -m qwen3_tts_tpu_torch.tools.soak_daemon [--seconds 120]
        [--batch 4] [--decode_chunk 32] [--paged] [--pipeline_depth 2]
        [--tiny] [--seed 0] [--device cuda|cpu]

For ``--seconds`` of wall clock it keeps up to 3 x batch requests in
flight through a started ContinuousBatcher (its scheduler thread, as the
daemon runs it), a random mix of the serving tier's request surface:
blob, streaming, voice-cloned, budget-capped, and cancelled (one in ten:
half as soon as submitted, half once decoding, the client that vanishes
mid-decode). Then it drains and stops the batcher and checks that it
ended healthy:

- every Future resolved, and none failed but the cancelled ones;
- no scheduler step raised;
- every slot free and, paged, every page back in the pool;
- every result's audio is n_codes x 1920 samples, a capped request kept
  its cap, and a stream's segments concatenate to its audio.

One JSON line on stdout (``"healthy"``), progress on stderr; exit code 0
only when healthy. ``--tiny`` runs the tiny geometry in f32 (seconds on
the CPU with ``--device cpu``); the default is the full geometry in bf16
on the card, random weights.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from qwen3_tts_tpu_torch.tools import log


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seconds", type=float, default=120.0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--decode_chunk", type=int, default=32)
    ap.add_argument("--paged", action="store_true")
    ap.add_argument("--pipeline_depth", type=int, default=2, choices=[1, 2],
                    help="the daemon's default, 2")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    out = soak(**vars(args))
    print(json.dumps(out))
    return 0 if out["healthy"] else 1


def soak(seconds: float = 120.0, batch: int = 4, decode_chunk: int = 32,
         paged: bool = False, pipeline_depth: int = 2, tiny: bool = False,
         seed: int = 0, device="cuda", engine=None) -> dict:
    """Run the soak; returns its counters and ``healthy``. ``engine``: a
    port TTSEngine whose weights to serve (a random one of the geometry
    by default)."""
    from qwen3_tts_tpu_torch.config import TTSConfig, tiny_tts_config
    from qwen3_tts_tpu_torch.engine.engine import TTSEngine
    from qwen3_tts_tpu_torch.serve.batching import ContinuousBatcher

    dtype = torch.float32 if tiny else torch.bfloat16
    if engine is None:
        cfg = tiny_tts_config(max_tokens=32) if tiny else TTSConfig()
        engine = TTSEngine(cfg, dtype=dtype, device=device)
    cfg = engine.cfg
    b = ContinuousBatcher(cfg, engine.params, batch_size=batch,
                          decode_chunk=decode_chunk, dtype=dtype,
                          paged=paged, pipeline_depth=pipeline_depth,
                          device=engine.device)
    free0 = len(b._free_pages) if paged else None
    step_failures = []
    real_step = b.step

    def counted_step():
        try:
            return real_step()
        except Exception as e:
            step_failures.append(repr(e))
            raise

    b.step = counted_step
    log(f"device: {b.device}  batch={batch} chunk={decode_chunk} "
        f"paged={paged} depth={pipeline_depth} seconds={seconds}")
    b.start()
    rng = np.random.default_rng(seed)
    V = cfg.code_predictor.group_vocab_size
    texts = [f"soak sentence number {i} with several words of filler."
             for i in range(16)]
    ids, n = engine._encode_text(texts[0])
    b.submit(np.asarray(ids), int(n), seed=0).result(timeout=1800)
    log("warmup done")

    inflight = []   # [future, kind, segments or None, cap]
    stats = {"ok": 0, "cancelled": 0, "cancelled_mid": 0, "errors": 0,
             "tokens": 0, "audio_s": 0.0, "submitted": 0,
             "stream_mismatch": 0, "length_mismatch": 0, "over_cap": 0}
    t0 = time.monotonic()
    deadline = t0 + seconds
    i = 0
    while time.monotonic() < deadline or inflight:
        while time.monotonic() < deadline and len(inflight) < batch * 3:
            i += 1
            ids, n = engine._encode_text(texts[i % len(texts)])
            kw, kind, segs, cap = {}, "blob", None, None
            r = rng.random()
            if r < 0.2:
                segs = []
                kw["on_chunk"] = segs.append
                kind = "stream"
            elif r < 0.35:
                kw["ref_codes"] = rng.integers(0, V, (12, 16))
                kw["n_target"] = max(int(n) - 2, 1)
                kind = "cloned"
            elif r < 0.5:
                cap = int(rng.integers(2, 24))
                kw["max_tokens"] = cap
                kind = "capped"
            fut = b.submit(np.asarray(ids), int(n), seed=i, **kw)
            stats["submitted"] += 1
            c = rng.random()
            if c < 0.05:          # gone before admission
                fut.request.cancelled = True
                kind = "cancel"
            elif c < 0.1:         # gone once it decodes
                kind = "cancel_mid"
            inflight.append([fut, kind, segs, cap])
        still = []
        for entry in inflight:
            fut, kind, segs, cap = entry
            if kind == "cancel_mid" and fut.request.t_first is not None:
                fut.request.cancelled = True
                entry[1] = kind = "cancel"
                stats["cancelled_mid"] += 1
            if not fut.done():
                still.append(entry)
                continue
            try:
                codes, audio = fut.result(timeout=1)
                if len(audio) != len(codes) * 1920:
                    stats["length_mismatch"] += 1
                if kind == "stream" and segs and not np.array_equal(
                        np.concatenate(segs), audio):
                    stats["stream_mismatch"] += 1
                if cap is not None and len(codes) > cap:
                    stats["over_cap"] += 1
                stats["ok"] += 1
                stats["tokens"] += len(codes)
                stats["audio_s"] += len(audio) / 24000.0
            except Exception as e:
                if kind == "cancel" and "cancelled" in str(e):
                    stats["cancelled"] += 1
                else:
                    stats["errors"] += 1
                    log(f"ERROR result ({kind}): {e!r}")
        inflight = still
        time.sleep(0.01)
    wall = time.monotonic() - t0
    b.stop()
    slots_free = all(r is None for r in b._slot_req)
    pages_ok = (len(b._free_pages) == free0) if paged else True
    healthy = (stats["errors"] == 0 and stats["stream_mismatch"] == 0
               and stats["length_mismatch"] == 0 and stats["over_cap"] == 0
               and not step_failures and slots_free and pages_ok
               and b._thread is None)    # a clean stop() resets it
    out = {"metric": "soak", **stats, "wall_s": wall,
           "audio_s_per_wall_s": stats["audio_s"] / wall if wall else 0.0,
           "step_failures": len(step_failures), "slots_free": slots_free,
           "pages_recovered": pages_ok, "healthy": bool(healthy)}
    return out


if __name__ == "__main__":
    sys.exit(main())
