"""The yardstick's counts against hand counts at TTSConfig()'s shapes."""

import json

from benchmark import roofline
from benchmark.tests.tiny import REPO


def _cfg():
    return json.loads((REPO / "benchmark" / "configs" /
                       "qwen3-tts-0.6b-int8.json").read_text())


def test_layer_counts():
    t = _cfg()["talker"]
    # q 1024x2048, k and v 1024x1024, o 2048x1024, gate/up/down 1024x3072
    assert roofline.layer_params(t) == (2 * 1024 * 1024 + 2 * 1024 * 1024
                                        + 2048 * 1024 + 3 * 1024 * 3072)
    assert roofline.layer_params(t) == 15_728_640
    assert roofline.layer_scales(t) == 4096 + 1024 + 6144 + 1024


def test_k3_bytes():
    t = _cfg()["talker"]
    n_bytes, flops = roofline.k3_call(t, B=1, kv_rows=491)
    w = 28 * (15_728_640 + 4 * 12_288)
    norms = 28 * (2 * 1024 + 2 * 128) * 2
    kv = 28 * 2 * 491 * 8 * 128 * 2
    assert n_bytes == w + norms + 2 * 1024 * 2 + kv + 28 * 2 * 8 * 128 * 4
    assert flops == 2 * 28 * 15_728_640 + 4 * 491 * 16 * 128 * 28
    # bytes bound it: about 0.15 ms at B = 1, pos 490 (PERF.md's K3 row)
    assert abs(roofline.least_s(n_bytes, flops) * 1e3 - 0.1488) < 0.002


def test_k2_bytes():
    c = _cfg()["code_predictor"]
    n_bytes, _ = roofline.k2_call(c, B=1)
    stack = 5 * (15_728_640 + 4 * 12_288)
    heads = 14 * (1024 * 2048 + 4 * 2048)
    assert n_bytes > stack + heads
    # inputs once: about 0.033 ms (PERF.md's K2 row)
    assert abs(n_bytes / roofline.HBM_BYTES_PER_S * 1e3 - 0.0330) < 0.002


def test_k4_bytes():
    t = _cfg()["talker"]
    n_bytes, flops = roofline.k4_call(t, B=4, kv_rows=943, max_pages=9)
    assert n_bytes == (4 * 2048 * 2 + 16 + 2 * 943 * 8 * 128 * 2
                       + 4 * 9 * 4 + 4 * 2048 * 2)
    assert flops == 4.0 * 943 * 16 * 128


def test_model_flops():
    cfg = _cfg()
    one = roofline.talker_cp_flops(cfg, 10, 1, 1)
    two = roofline.talker_cp_flops(cfg, 10, 2, 2)
    # a further token: one talker step and the code predictor's 16
    # positions, 2 flops a weight, and its attention and heads
    step = 2 * 28 * 15_728_640 + 2 * 16 * 5 * 15_728_640
    assert step < two - one < step * 1.05
    v = cfg["vocoder"]
    assert 4.0e9 < roofline.vocoder_flops(v, 1) < 5.5e9
