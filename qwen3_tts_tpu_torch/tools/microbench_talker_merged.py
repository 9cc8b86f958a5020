"""Talker fused-step experiment on the port: two merged weight streams
against the four (plus eight vectors) of K3, measured in the production
decode loop; twin of the JAX package's
tools/dev/microbench_talker_merged.py.

Hypothesis (the JAX tool's): the fused step streams its weights, and
fewer, larger per-layer weight blocks -- [qkv | gate|up] and [o ; down],
K7 in ops/kernels/talker_merged.py -- stream them faster. A third variant
("mergedvec") also merges the eight per-layer f32 vectors into one block.

Method: int8 engine parameters at the chosen geometry with random weights,
premerged once; engine/generate.run_steps decodes ``n_tokens`` with the
talker step swapped in models/talker (where decode_step looks it up) for
``full`` (K3), ``merged`` and ``mergedvec`` (K7). The math is identical,
so the first run of every variant must give the same codes (asserted).
Then interleaved trials, each from a fresh prefill with its own key; the
median ms per token of each variant is printed as one JSON line.

    python -m qwen3_tts_tpu_torch.tools.microbench_talker_merged \\
        [n_tokens] [trials] [--device cuda] [--tiny]
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from qwen3_tts_tpu_torch.config import TTSConfig, tiny_tts_config
from qwen3_tts_tpu_torch.engine import generate as gen
from qwen3_tts_tpu_torch.io.weights import init_random_params
from qwen3_tts_tpu_torch.models import talker as tk
from qwen3_tts_tpu_torch.ops import quant
from qwen3_tts_tpu_torch.ops import sampling as smp
from qwen3_tts_tpu_torch.ops.kernels.talker_merged import (
    talker_decode_step_merged, talker_decode_step_mergedvec, with_merged)
from qwen3_tts_tpu_torch.ops.kernels.talker_step import (
    talker_decode_step_fused)
from qwen3_tts_tpu_torch.tools import log, log_device, sync

# variant -> the talker step swapped into models/talker
VARIANTS = {"full": talker_decode_step_fused,
            "merged": talker_decode_step_merged,
            "mergedvec": talker_decode_step_mergedvec}
N_TEXT = 30
SEED = 0      # weights and the checked runs' sampling key


@torch.inference_mode()
def run(cfg: TTSConfig, n_tok: int = 96, trials: int = 6,
        device="cuda") -> dict:
    """The three variants through run_steps. Returns {"ms_per_tok":
    {variant: median}, "n_codes": n and "codes" (n, 16) of the checked
    runs, "launches": {variant: {each variant: launches of its step
    during this variant's checked run}}}."""
    dev = torch.device(device)
    params = init_random_params(cfg, SEED, torch.bfloat16, dev)
    tp = quant.quantize_talker(params["talker"])
    cpp = quant.quantize_code_predictor(params["code_predictor"])
    del params
    tp_m = dict(tp, layers=with_merged(tp["layers"]))
    ids = torch.arange(100, 132, dtype=torch.int32, device=dev)
    n_text = torch.tensor([N_TEXT], dtype=torch.int32, device=dev)
    log_device(dev)

    def decode(name: str, key: int):
        prefix, plen = tk.build_prefix(tp, ids, N_TEXT)
        s = gen.init_state(tp, prefix[None], plen[None], n_text,
                           smp.batch_keys(key, 1), cfg)
        real = tk.talker_decode_step_fused
        tk.talker_decode_step_fused = VARIANTS[name]
        try:
            sync(dev)
            t0 = time.perf_counter()
            s = gen.run_steps(tp if name == "full" else tp_m, cpp, s, cfg,
                              n_tok)
            n = int(s.n_codes[0])
            dt = time.perf_counter() - t0
        finally:
            tk.talker_decode_step_fused = real
        return s, n, dt

    checks, launches = {}, {}
    for name in VARIANTS:
        before = {k: fn.launches for k, fn in VARIANTS.items()}
        s, n, dt = decode(name, SEED)
        launches[name] = {k: fn.launches - before[k]
                          for k, fn in VARIANTS.items()}
        checks[name] = (n, s.codes[0, :n].cpu().clone())
        log(f"{name}: first run {dt:.1f}s n_codes={n} code sum="
            f"{int(checks[name][1].sum())} launches={launches[name]}")
    n0, codes0 = checks["full"]
    for name, (n, codes) in checks.items():
        if n != n0 or not torch.equal(codes, codes0):
            raise AssertionError(f"{name} kernel diverged from full: n_codes "
                                 f"{n} against {n0}")

    results = {k: [] for k in VARIANTS}
    for trial in range(trials):
        for name in VARIANTS:
            _, n, dt = decode(name, SEED + 10 + trial)
            results[name].append(dt / max(n, 1) * 1000)
            log(f"trial {trial} {name}: n={n} {dt * 1000:.0f}ms -> "
                f"{results[name][-1]:.2f} ms/tok")
    med = {k: statistics.median(v) for k, v in results.items() if v}
    log(f"medians ms/tok: {med}")
    return {"ms_per_tok": med, "n_codes": n0, "codes": codes0,
            "launches": launches}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_tokens", nargs="?", type=int, default=96)
    ap.add_argument("trials", nargs="?", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help="config.tiny_tts_config() instead of TTSConfig()")
    args = ap.parse_args(argv)
    cfg = tiny_tts_config() if args.tiny else TTSConfig()
    res = run(cfg, n_tok=args.n_tokens, trials=args.trials,
              device=args.device)
    print(json.dumps({"metric": "talker_merged_streams_ms_per_tok",
                      **res["ms_per_tok"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
