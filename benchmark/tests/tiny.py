"""A tiny copy of the benchmark for CPU tests: the manifest, the folder,
and every configuration and traffic file cut to tiny_tts_config()'s
widths and to a few short requests, in a temporary root."""

from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
TINY_TALKER = dict(num_layers=2, hidden_size=64, intermediate_size=128,
                   num_heads=4, num_kv_heads=2, head_dim=16,
                   text_embed_dim=32, max_seq_len=128)
TINY_CP = dict(num_layers=2, hidden_size=64, intermediate_size=128,
               num_heads=4, num_kv_heads=2, head_dim=16)
TINY_VOC = dict(hidden_size=16, num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=4, intermediate_size=32,
                sliding_window=8, decoder_dim=32)


def tiny_config(d: dict) -> dict:
    """The configuration at tiny widths. Its logits spread a quarter as
    wide (N(0, 0.02) weights over a hidden of 64, not 1024), so its
    token limit is a quarter of the full size's."""
    d = json.loads(json.dumps(d))
    d["limits"] = dict(d["limits"], token_gap=d["limits"]["token_gap"] / 4)
    d["talker"].update(TINY_TALKER)
    d["code_predictor"].update(TINY_CP)
    d["vocoder"].update(TINY_VOC)
    d["max_tokens"] = 24
    return d


def make_root(dst: Path) -> Path:
    """dst/BENCHMARK.json and dst/benchmark/ at tiny sizes."""
    shutil.copytree(REPO / "benchmark", dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    m = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in m["configs"]:
        p = dst / c["file"]
        p.write_text(json.dumps(tiny_config(json.loads(p.read_text()))))
    for p in (dst / "benchmark" / "traffic").glob("*.json"):
        t = json.loads(p.read_text())
        t["decode_chunk"] = 4
        if t["kind"] == "closed":
            t["n_text"] = {"dist": "uniform", "min": 4, "max": 10}
        else:
            t["rate_per_s"] = 3.0
            t["n_text"] = {"dist": "lognormal", "median": 5, "sigma": 0.5,
                           "min": 3, "max": 10}
        p.write_text(json.dumps(t))
    (dst / "BENCHMARK.json").write_text(json.dumps(m))
    return dst


def run(root: Path, workload: str, seed: int = 5, seconds: float = 3.0,
        trace: bool = False, **kw) -> dict:
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    from benchmark import harness
    return harness.run(workload, seed, seconds, trace, root,
                       time.perf_counter(), device="cpu", **kw)
