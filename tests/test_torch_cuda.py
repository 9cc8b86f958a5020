"""The port's CUDA kernels against their plain PyTorch versions, on the
card, at small shapes. Each plain version adds up in its kernel's order,
so kernel and plain version must agree bit for bit; the one exception is
K1's tensor-core tile for prefill rows, whose MMA sums in the hardware's
order: it is held to the normalised-error bound ``qmatmul.TILE_TOL``
(2^-16 of the sum of |terms|, against the product summed in float64),
beside qmm's own error, and to equal bits on every launch.

Every test skips where there is no CUDA device. The file imports no jax,
so it also runs on a GPU machine without it (the suite's conftest.py
imports jax, hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from qwen3_tts_tpu_torch.models import transformer as tfm
from qwen3_tts_tpu_torch.ops import quant
from qwen3_tts_tpu_torch.ops.kernels import cp_decode as tcp
from qwen3_tts_tpu_torch.ops.kernels import qmatmul as tqm
from qwen3_tts_tpu_torch.ops.kernels import talker_step as tts
from qwen3_tts_tpu_torch.ops.kernels.common import qmm

pytestmark = pytest.mark.cuda

# talker-step geometry of tests/test_talker_kernel.py
TGEO = tfm.TransformerGeometry(
    num_layers=2, hidden_size=256, intermediate_size=256, num_heads=2,
    num_kv_heads=1, head_dim=128, rms_norm_eps=1e-6, rope_theta=1e6)
# a small code predictor: H=64, Dh=16, 2 layers, full 2048-code groups
CGEO = tfm.TransformerGeometry(
    num_layers=2, hidden_size=64, intermediate_size=128, num_heads=4,
    num_kv_heads=2, head_dim=16, rms_norm_eps=1e-6, rope_theta=1e6)
CP_GROUPS, CP_VOCAB, CP_S = 15, 2048, 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                    "mode; tests/test_torch_kernels.py holds their plain "
                    "versions to the JAX kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _stack(rng, geo, dev, scale=0.02):
    """A float32 layer stack (JAX init shapes) on ``dev``."""
    L, H, I = geo.num_layers, geo.hidden_size, geo.intermediate_size
    QD, KVD = geo.num_heads * geo.head_dim, geo.num_kv_heads * geo.head_dim

    def w(*shape):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    def norm(*shape):
        return torch.from_numpy((1.0 + 0.1 * rng.standard_normal(shape))
                                .astype(np.float32)).to(dev)

    return {"input_ln": norm(L, H), "post_ln": norm(L, H),
            "q_norm": norm(L, geo.head_dim), "k_norm": norm(L, geo.head_dim),
            "q_proj": w(L, H, QD), "k_proj": w(L, H, KVD),
            "v_proj": w(L, H, KVD), "o_proj": w(L, QD, H),
            "gate_proj": w(L, H, I), "up_proj": w(L, H, I),
            "down_proj": w(L, I, H)}


def _assert_k1(got, x, q, s, route):
    """qsplit bit-equal to qmatmul_plain; the tile within TILE_TOL of the
    float64 product, as qmm is."""
    if route == "qsplit":
        torch.testing.assert_close(got, tqm.qmatmul_plain(x, q, s), rtol=0,
                                   atol=0)
    else:
        assert torch.isfinite(got).all()
        assert tqm.qmatmul_error(got, x, q, s) <= tqm.TILE_TOL
        assert tqm.qmatmul_error(tqm.qmatmul_plain(x, q, s), x, q,
                                 s) <= tqm.TILE_TOL


@pytest.mark.parametrize("M", [1, 2, 73])
def test_qmatmul_kernel_matches_plain(cuda, M):
    g = torch.Generator(device=cuda).manual_seed(M)
    x = torch.randn((M, 1024), generator=g, device=cuda).bfloat16()
    q = torch.randint(-127, 128, (1024, 3072), generator=g, device=cuda,
                      dtype=torch.int8)
    s = torch.rand((3072,), generator=g, device=cuda) * 0.01 + 1e-3
    _assert_k1(tqm.qmatmul(x, q, s), x, q, s, tqm.route(M, 1024, 3072))


def _k1_case(cuda, seed, M, K, Ns, dtype=torch.bfloat16):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((M, K), generator=g, device=cuda).to(dtype)
    ws = [(torch.randint(-127, 128, (K, N), generator=g, device=cuda,
                         dtype=torch.int8),
           torch.rand((N,), generator=g, device=cuda) * 0.01 + 1e-3)
          for N in Ns]
    return x, ws


def _k1_counts():
    return (tqm.qmatmul.launches, tqm.qmatmul_qsplit.launches,
            tqm.qmatmul_tile.launches)


# (M, K, N, x dtype, route): decode rows on qsplit at the CP prefill's and
# the heads' widths, f32 rows too; 73 rows and an N off 16 on the tile
K1_ROUTES = [(M, 1024, 3072, torch.bfloat16, "qsplit") for M in range(1, 9)]
K1_ROUTES += [(2, 2048, 1024, torch.bfloat16, "qsplit"),
              (2, 3072, 1024, torch.float32, "qsplit"),
              (4, 1024, 2048, torch.float32, "qsplit"),
              (73, 1024, 4096, torch.bfloat16, "tile"),
              (9, 1024, 1024, torch.float32, "tile"),
              (1, 1024, 1032, torch.bfloat16, "tile")]


@pytest.mark.parametrize("M,K,N,dtype,route", K1_ROUTES)
def test_qmatmul_routes_match_plain(cuda, M, K, N, dtype, route):
    """qsplit at error 0 against qmatmul_plain, the tile within its bound;
    one launch on the route the shape picks."""
    x, [(q, s)] = _k1_case(cuda, M + N, M, K, [N], dtype)
    before = _k1_counts()
    got = tqm.qmatmul(x, q, s)
    a, b, c = (n - m for n, m in zip(_k1_counts(), before))
    assert (a, b, c) == ((1, 1, 0) if route == "qsplit" else (1, 0, 1))
    _assert_k1(got, x, q, s, route)


# the tile's shapes: the talker prefill's products at the slice's R = 41,
# R = 73 and the largest bucket's 265, rows on and off the 16-row steps
# and the 64-row tiles, an N off 16 and off 64, K past 64-k stages
K1_TILE = [(9, 1024, 1024), (16, 2048, 1032), (41, 1024, 4096),
           (41, 2048, 1024), (41, 1024, 6144), (41, 3072, 1024),
           (64, 1024, 4096), (73, 1024, 4096), (265, 1024, 4096),
           (265, 2048, 1024), (265, 1024, 6144), (265, 3072, 1024),
           (100, 48, 40), (41, 1040, 256)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("M,K,N", K1_TILE)
def test_qmatmul_tile_within_bound_and_repeatable(cuda, M, K, N, dtype):
    """The tile within TILE_TOL of the float64 product (qmm beside it),
    one tile launch a call, and the same bits on a second launch (the K
    split adds its partials in rank order, without atomics)."""
    x, [(q, s)] = _k1_case(cuda, M * 7 + N, M, K, [N], dtype)
    assert tqm.route(M, K, N) == "tile"
    before = _k1_counts()
    a = tqm.qmatmul(x, q, s)
    b = tqm.qmatmul(x, q, s)
    assert tuple(n - m for n, m in zip(_k1_counts(), before)) == (2, 0, 2)
    _assert_k1(a, x, q, s, "tile")
    assert torch.equal(a, b)


def test_qmatmul_tile_refuses_k_off_16(cuda):
    """K % 16 != 0 past 8 rows is on no route: ValueError, no launch."""
    x, [(q, s)] = _k1_case(cuda, 21, 41, 1000, [256])
    before = _k1_counts()
    with pytest.raises(ValueError):
        tqm.qmatmul(x, q, s)
    assert _k1_counts() == before


def test_qmatmul_tile_misaligned_x(cuda):
    """x two bytes off 16-byte alignment at prefill rows: cloned, the tile
    within its bound."""
    _, [(q, s)] = _k1_case(cuda, 23, 41, 1024, [4096])
    g = torch.Generator(device=cuda).manual_seed(24)
    x = torch.randn((41, 1025), generator=g, device=cuda).bfloat16()[:, 1:]
    assert x.data_ptr() % 16 != 0
    _assert_k1(tqm.qmatmul(x, q, s), x, q, s, "tile")


@pytest.mark.parametrize("M", [1, 2, 8])
@pytest.mark.parametrize("Ns", [[3072, 3072], [2048, 1024, 1024]],
                         ids=["gate|up", "q|k|v"])
def test_qmatmul_group_one_launch_matches_plain(cuda, Ns, M):
    """The grouped entry point with 2 and 3 segments: one qsplit launch,
    each output bit-equal to its weight's plain product."""
    x, ws = _k1_case(cuda, M + len(Ns), M, 1024, Ns)
    before = _k1_counts()
    outs = tqm.qmatmul_group(x, ws)
    assert tuple(n - m for n, m in zip(_k1_counts(), before)) == (1, 1, 0)
    for o, (q, s) in zip(outs, ws):
        torch.testing.assert_close(o, tqm.qmatmul_plain(x, q, s), rtol=0,
                                   atol=0)


# the code predictor's int8 products on one rank of a tp mesh (parallel/
# mesh.py) at full geometry: q|k|v and gate|up column shards, o and down
# row shards (K split), an lm_head vocabulary shard
CP_TP_SHARDS = {(tp, name): shape for tp in (2, 4) for name, shape in {
    "q|k|v": (1024, [2048 // tp, 1024 // tp, 1024 // tp]),
    "gate|up": (1024, [3072 // tp] * 2),
    "o": (2048 // tp, [1024]), "down": (3072 // tp, [1024]),
    "lm_head": (1024, [2048 // tp])}.items()}


@pytest.mark.parametrize("M", [1, 8, 16])
@pytest.mark.parametrize("tp,name", list(CP_TP_SHARDS))
def test_qmatmul_on_cp_tp_shards(cuda, tp, name, M):
    """K1 at a tp rank's shard shapes: decode rows (M <= 8, the group in
    one qsplit launch) bit for bit against the plain version, the
    2-token prefill of 8 rows (M = 16) on the tile within its bound."""
    K, Ns = CP_TP_SHARDS[tp, name]
    x, ws = _k1_case(cuda, M * 7 + K + sum(Ns), M, K, Ns)
    before = _k1_counts()
    outs = tqm.qmatmul_group(x, ws)
    qsplit = tqm.on_qsplit(M, K, Ns)
    assert tuple(n - m for n, m in zip(_k1_counts(), before)) == (
        (1, 1, 0) if qsplit else (len(Ns), 0, len(Ns)))
    for o, (q, s) in zip(outs, ws):
        _assert_k1(o, x, q, s, "qsplit" if qsplit else "tile")


def test_qmatmul_group_qsplit_refuses_runs_one_launch_a_weight(cuda):
    """A group at prefill rows: one tile launch a weight, each within the
    tile's bound."""
    x, ws = _k1_case(cuda, 5, 12, 1024, [1024, 2048])
    before = _k1_counts()
    outs = tqm.qmatmul_group(x, ws)
    assert tuple(n - m for n, m in zip(_k1_counts(), before)) == (2, 0, 2)
    for o, (q, s) in zip(outs, ws):
        _assert_k1(o, x, q, s, "tile")


def test_qmatmul_misaligned_x(cuda):
    """x two bytes off 16-byte alignment (a bf16 view one element in):
    cloned for qsplit, which reads its rows 16 bytes at a time; the same
    bits."""
    _, [(q, s)] = _k1_case(cuda, 17, 1, 1024, [3072])
    g = torch.Generator(device=cuda).manual_seed(18)
    x = torch.randn((1, 1025), generator=g, device=cuda).bfloat16()[:, 1:]
    assert x.data_ptr() % 16 != 0
    torch.testing.assert_close(tqm.qmatmul(x, q, s),
                               tqm.qmatmul_plain(x, q, s), rtol=0, atol=0)


# K3 with 4 query heads of 64 per KV head: the attention's generic
# instantiation (more than 2 heads a group, 8 lanes a row)
TGEO4 = tfm.TransformerGeometry(
    num_layers=2, hidden_size=256, intermediate_size=256, num_heads=8,
    num_kv_heads=2, head_dim=64, rms_norm_eps=1e-6, rope_theta=1e6)
# K3 cases (B, positions, cache dtype, geometry) at S = 64: the attention's
# chunks are ceil(64 / 8) = 8 positions, so 0, 7, 8 and 63 sit on chunk
# edges
K3_CASES = {
    "B1-first": (1, [0], torch.bfloat16, TGEO),
    "B1-last": (1, [63], torch.bfloat16, TGEO),
    "B3-edges": (3, [7, 8, 40], torch.bfloat16, TGEO),
    "B3-f32": (3, [8, 63, 0], torch.float32, TGEO),
    "B8-edges": (8, [0, 7, 8, 63, 1, 15, 16, 33], torch.bfloat16, TGEO),
    "B3-G4-Dh64": (3, [63, 8, 0], torch.bfloat16, TGEO4),
}


@pytest.mark.parametrize("case", list(K3_CASES))
def test_talker_step_kernel_matches_plain(cuda, case):
    B, pos, dtype, geo = K3_CASES[case]
    rng = np.random.default_rng(B)
    layers = quant.quantize_layer_stack(_stack(rng, geo, cuda), fuse=True)
    g = torch.Generator(device=cuda).manual_seed(B)
    x = torch.randn((B, geo.hidden_size), generator=g,
                    device=cuda).bfloat16()
    kv = torch.randn((geo.num_layers, 2, B, 64, geo.num_kv_heads,
                      geo.head_dim), generator=g, device=cuda).to(dtype)
    pos = torch.tensor(pos, device=cuda)
    cos, sin = tfm.rope_cos_sin(torch.arange(64, device=cuda),
                                geo.head_dim, geo.rope_theta)
    h_k, r_k = tts.talker_step_cuda(layers, x, pos, kv, cos, sin, 1e-6)
    h_p, r_p = tts.talker_step_plain(layers, x, pos, kv, cos, sin, 1e-6)
    torch.testing.assert_close(h_k, h_p, rtol=0, atol=0)
    torch.testing.assert_close(r_k, r_p, rtol=0, atol=0)
    # the wrapper takes pos as int64 or int32 alike
    h_32, r_32 = tts.talker_step_cuda(layers, x, pos.int(), kv, cos, sin,
                                      1e-6)
    assert torch.equal(h_32, h_k) and torch.equal(r_32, r_k)


@pytest.mark.parametrize("pos", [[490], [0, 63, 64, 511, 127, 128, 200, 37]])
def test_talker_step_full_geometry_matches_plain(cuda, pos):
    """K3 at the 0.6B talker's geometry (random int8 weights, S 512,
    chunks of 64): h and the fresh rows equal the plain version's bit for
    bit, at B = 1 and at B = 8 with positions on chunk edges."""
    from qwen3_tts_tpu_torch.tools import bench_talker_step as bench
    cfg, layers = bench.talker_layers()
    x, kv, p = bench.inputs(cfg, pos, seed=len(pos))
    cos, sin = tfm.rope_cos_sin(torch.arange(bench.S, device=cuda),
                                cfg.head_dim, cfg.rope_theta)
    args = (layers, x, p, kv, cos, sin, cfg.rms_norm_eps)
    for got, want in zip(tts.talker_step_cuda(*args),
                         tts.talker_step_plain(*args)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("greedy", [True, False])
def test_cp_decode_kernel_matches_plain(cuda, greedy):
    rng = np.random.default_rng(1)
    B, H = 3, CGEO.hidden_size

    def w(*shape, scale=0.02):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)).to(cuda)

    params = quant.quantize_code_predictor({
        "layers": _stack(rng, CGEO, cuda),
        "final_norm": torch.ones((H,), device=cuda),
        "mtp_proj_w": w(H, H), "mtp_proj_b": w(H),
        "codec_embs": w(CP_GROUPS, CP_VOCAB, H),
        "lm_heads": w(CP_GROUPS, H, CP_VOCAB, scale=0.2)})
    kv = torch.zeros((CGEO.num_layers, 2, B, CP_S, CGEO.num_kv_heads,
                      CGEO.head_dim), device=cuda)
    kv[:, :, :, :2] = w(*kv[:, :, :, :2].shape, scale=0.5)
    tok0 = torch.from_numpy(rng.integers(0, CP_VOCAB, (B,))
                            .astype(np.int32)).to(cuda)
    seeds = torch.arange(B, dtype=torch.int32, device=cuda) * 7919 + 11
    cos, sin = tfm.rope_cos_sin(torch.arange(CP_S, device=cuda),
                                CGEO.head_dim, CGEO.rope_theta)
    kw = dict(eps=CGEO.rms_norm_eps, top_k=50,
              temperature=0.0 if greedy else 0.1, greedy=greedy,
              scratch=True)
    args = (params, tok0, kv, cos, sin, seeds)
    # tokens, and the last step's logits and residual row, bit for bit
    for got, want in zip(tcp.cp_decode_cuda(*args, **kw),
                         tcp.cp_decode_plain(*args, **kw)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("B", [1, 4, 8])
def test_cp_decode_full_geometry_matches_plain(cuda, B):
    """K2 at the 0.6B code predictor's geometry (random int8 weights),
    greedy: every token, the last step's logits and its residual row
    equal the plain version's bit for bit."""
    from qwen3_tts_tpu_torch.tools import bench_cp_decode as bench
    cfg, params = bench.cp_params()
    kv, tok0, seeds = bench.inputs(cfg, B, seed=B)
    cos, sin = tfm.rope_cos_sin(torch.arange(cfg.max_seq_len, device=cuda),
                                cfg.head_dim, cfg.rope_theta)
    kw = dict(eps=cfg.rms_norm_eps, top_k=50, temperature=0.0, greedy=True,
              scratch=True)
    args = (params, tok0, kv, cos, sin, seeds)
    for got, want in zip(tcp.cp_decode_cuda(*args, **kw),
                         tcp.cp_decode_plain(*args, **kw)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def _cp_graph_counts():
    """The recorder's (captures, replays, eager calls) of the prelude."""
    from qwen3_tts_tpu_torch.utils import profiling
    c = profiling.snapshot()["counters"]
    return tuple(c.get(k, 0) for k in ("cp_graph_captures",
                                       "cp_graph_replays", "cp_eager_calls"))


def _prelude_inputs(cfg, B, g):
    """A talker hidden, a code-0 embedding and the CP seeds (B, 2): the
    token_seeds columns the loop passes, a strided int64 view."""
    from qwen3_tts_tpu_torch.ops import sampling as smp
    H = cfg.hidden_size
    hidden = torch.randn((B, H), generator=g, device="cuda").bfloat16()
    c0 = (torch.randn((B, H), generator=g, device="cuda") * 0.02).bfloat16()
    keys = torch.randint(0, 2 ** 62, (B,), generator=g, device="cuda")
    n = torch.randint(0, 200, (B,), generator=g, device="cuda")
    return hidden, c0, smp.token_seeds(keys, n)[:, 1:]


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
@pytest.mark.parametrize("B", [1, 8])
def test_cp_prelude_graph_equals_the_eager_prelude(cuda, B, greedy):
    """At the 0.6B code predictor's geometry (random int8 weights): the
    prelude replayed as a CUDA graph gives the eager prelude's tok0, KV
    cache, K2 seeds and rope tables, and predict_codes the eager path's
    groups, bit for bit, over replays with fresh inputs; an eager call
    at another B between replays changes nothing. One capture, one
    replay a call, and a replay counts the K1 launches of an eager
    prelude."""
    from qwen3_tts_tpu_torch.config import SamplingConfig
    from qwen3_tts_tpu_torch.models import code_predictor as cpm
    from qwen3_tts_tpu_torch.tools import bench_cp_decode as bench
    cfg, params = bench.cp_params()
    scfg = SamplingConfig(cp_temperature=0.0 if greedy else 0.9)
    g = torch.Generator(device="cuda").manual_seed(B)
    fused = cpm._fused_kernel_ok(params, B)
    assert fused
    c0 = _cp_graph_counts()
    for i in range(5):
        if i == 3:
            other = _prelude_inputs(cfg, B + 3 if B < 8 else 3, g)
            cpm._decode(params, *cpm._prelude(params, *other, cfg, scfg,
                                              rope=True), cfg, scfg)
        ins = _prelude_inputs(cfg, B, g)
        k1 = tqm.qmatmul.launches
        want = cpm._prelude(params, *ins, cfg, scfg, rope=True)
        eager_k1 = tqm.qmatmul.launches - k1
        assert eager_k1 > 0
        k1 = tqm.qmatmul.launches
        graph = cpm._prelude_graph(params, *ins, cfg, scfg, True)
        # the capture's warm-up launches; the capture itself launches none
        assert tqm.qmatmul.launches - k1 == (eager_k1 if i == 0 else 0)
        k1 = tqm.qmatmul.launches
        with graph.lock:
            got = graph.replay(*ins)
            assert tqm.qmatmul.launches - k1 == eager_k1
            for a, b in zip(got[:3] + got[3], want[:3] + want[3]):
                assert a.dtype == b.dtype and torch.equal(a, b)
        want_codes = cpm._decode(params, *want, cfg, scfg)
        codes = cpm.predict_codes(params, *ins, cfg, scfg)
        assert torch.equal(codes, want_codes)
        assert torch.equal(codes[:, 0], want[0])
    assert tuple(n - n0 for n, n0 in zip(_cp_graph_counts(), c0)) == (
        1, 10, 0)


def test_cp_prelude_graphs_are_bounded_and_recaptured(cuda):
    """Past MAX_GRAPHS keys the least recently used graph goes; its key's
    next call captures again and gives the eager path's groups; a call
    past K2's 8 rows (the per-step path after the prelude) replays too."""
    from qwen3_tts_tpu_torch.config import SamplingConfig
    from qwen3_tts_tpu_torch.models import code_predictor as cpm
    from qwen3_tts_tpu_torch.tools import bench_cp_decode as bench
    cfg, params = bench.cp_params()
    scfg = SamplingConfig(cp_temperature=0.0)
    g = torch.Generator(device="cuda").manual_seed(11)
    sizes = list(range(1, cpm.MAX_GRAPHS + 2)) + [1]
    caps = _cp_graph_counts()[0]
    for B in sizes:
        ins = _prelude_inputs(cfg, B, g)
        want = cpm._decode(params, *cpm._prelude(params, *ins, cfg, scfg,
                                                 rope=True), cfg, scfg)
        assert torch.equal(cpm.predict_codes(params, *ins, cfg, scfg), want)
        assert len(cpm._GRAPHS) <= cpm.MAX_GRAPHS
    assert _cp_graph_counts()[0] - caps == len(sizes)
    ins = _prelude_inputs(cfg, 9, g)
    assert not cpm._fused_kernel_ok(params, 9)
    want = cpm._decode(params, *cpm._prelude(params, *ins, cfg, scfg), cfg,
                       scfg)
    replays = _cp_graph_counts()[1]
    assert torch.equal(cpm.predict_codes(params, *ins, cfg, scfg), want)
    assert _cp_graph_counts()[1] == replays + 1


def test_cp_prelude_graph_shared_by_threads(cuda):
    """Threads that call predict_codes with the same weights and B on the
    same stream share one graph; its lock keeps each call's outputs
    until its reads are enqueued, so every call gets its own inputs'
    groups (more threads than the host's cores, a short switch
    interval)."""
    import os
    import sys
    import threading
    from qwen3_tts_tpu_torch.config import SamplingConfig
    from qwen3_tts_tpu_torch.models import code_predictor as cpm
    from qwen3_tts_tpu_torch.tools import bench_cp_decode as bench
    cfg, params = bench.cp_params()
    scfg = SamplingConfig(cp_temperature=0.9)
    g = torch.Generator(device="cuda").manual_seed(5)
    n_threads, calls = 2 * (os.cpu_count() or 4), 6
    jobs = [[_prelude_inputs(cfg, 4, g) for _ in range(calls)]
            for _ in range(n_threads)]
    want = [[cpm._decode(params, *cpm._prelude(params, *ins, cfg, scfg,
                                                rope=True), cfg, scfg)
             for ins in job] for job in jobs]
    got = [[None] * calls for _ in range(n_threads)]
    caps = _cp_graph_counts()[0]

    def work(t):
        for i, ins in enumerate(jobs[t]):
            got[t][i] = cpm.predict_codes(params, *ins, cfg, scfg)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert _cp_graph_counts()[0] - caps == 1
    for t in range(n_threads):
        for i in range(calls):
            assert torch.equal(got[t][i], want[t][i]), (t, i)


# (K, N) of every product of a K2 step at the 0.6B geometry, each alone
# and in the clusters it gets in a step: mtp, k and v, o, down (clusters
# of 8); q and the head, gate and up (4); q|k|v and gate|up at their
# grouped widths (2)
QSPLIT_WIDTHS = [(1024, 1024), (1024, 2048), (2048, 1024), (1024, 3072),
                 (3072, 1024), (1024, 4096), (1024, 6144)]


@pytest.mark.parametrize("R", [1, 4, 8])
@pytest.mark.parametrize("K,N", QSPLIT_WIDTHS)
def test_qsplit_matches_qmm(cuda, K, N, R):
    """K2's cluster-split product alone against qmm, bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(K + N + R)
    x = torch.randn((R, K), generator=g, device=cuda).bfloat16()
    w = torch.randint(-127, 128, (K, N), generator=g, device=cuda,
                      dtype=torch.int8)
    s = torch.rand((N,), generator=g, device=cuda) * 0.01 + 1e-3
    torch.testing.assert_close(tcp.qsplit(x, w, s), qmm(x, w, s),
                               rtol=0, atol=0)


@pytest.mark.parametrize("R", [1, 8])
@pytest.mark.parametrize("norm_dtype", [torch.float32, torch.bfloat16])
def test_qsplit_rms_f32_rows_and_residual_add(cuda, R, norm_dtype):
    """The two qsplit paths K3 runs and K2 does not, against qmm bit for
    bit: RMS-normed f32 rows (the f32 residual h, PRO_RMS) at q|k|v's
    width, and an f32 residual added to the product (EPI_ADD_F32) at o's
    and down's."""
    from qwen3_tts_tpu_torch.ops.kernels.common import rms_rows
    g = torch.Generator(device=cuda).manual_seed(R)
    h = torch.randn((R, 1024), generator=g, device=cuda)
    nw = (1 + 0.1 * torch.randn((1024,), generator=g, device=cuda)).to(
        norm_dtype)
    w = torch.randint(-127, 128, (1024, 4096), generator=g, device=cuda,
                      dtype=torch.int8)
    s = torch.rand((4096,), generator=g, device=cuda) * 0.01 + 1e-3
    torch.testing.assert_close(tcp.qsplit(h, w, s, norm=nw, eps=1e-6),
                               qmm(rms_rows(h, nw, 1e-6), w, s),
                               rtol=0, atol=0)
    for K in (2048, 3072):
        x = torch.randn((R, K), generator=g, device=cuda).bfloat16()
        w = torch.randint(-127, 128, (K, 1024), generator=g, device=cuda,
                          dtype=torch.int8)
        s = torch.rand((1024,), generator=g, device=cuda) * 0.01 + 1e-3
        torch.testing.assert_close(tcp.qsplit(x, w, s, residual=h),
                                   h + qmm(x, w, s), rtol=0, atol=0)


@pytest.mark.parametrize("R", [1, 8])
def test_qsplit_column_block_matches_dense(cuda, R):
    """qsplit on column blocks of a wider matrix (K7's q|k|v and gate|up
    inside [qkv | gate|up], row stride 10240 > N) against qmm on dense
    copies, bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(10 + R)
    x = torch.randn((R, 1024), generator=g, device=cuda).bfloat16()
    wide = torch.randint(-127, 128, (1024, 10240), generator=g, device=cuda,
                         dtype=torch.int8)
    s = torch.rand((10240,), generator=g, device=cuda) * 0.01 + 1e-3
    for lo, hi in ((0, 4096), (4096, 10240)):
        got = tcp.qsplit(x, wide[:, lo:hi], s[lo:hi])
        torch.testing.assert_close(
            got, qmm(x, wide[:, lo:hi].contiguous(), s[lo:hi]),
            rtol=0, atol=0)


# K5 cases (B, S, Hq, Hkv, Dh, pos): chunks of ceil(S / 8) positions, so
# at S = 512 positions 63 / 64 and 127 / 128 sit on split boundaries; S =
# 16 is the code predictor's cache (chunks of 2); a warp's sub-chunk is
# staged in tiles of 8 KB, so S = 1000 walks its 32 f32 rows of 128 in
# two tiles and S = 4096 its 128 rows in four (bf16) or eight (f32); G 2
# at Dh 128 is the talker's (compile-time) shape, at any S; every other G
# and Dh takes the generic instantiation
K5_CASES = {
    "B3-S80-G2-Dh64": (3, 80, 8, 4, 64, [0, 79, 33]),
    "B1-S512": (1, 512, 16, 8, 128, [511]),
    "B8-S512": (8, 512, 16, 8, 128, [0, 511, 63, 64, 127, 128, 200, 37]),
    "B4-S16": (4, 16, 16, 8, 128, [0, 15, 1, 2]),
    "B2-S2048-G8-Dh32": (2, 2048, 8, 1, 32, [2047, 700]),
    "B2-S1000": (2, 1000, 16, 8, 128, [999, 125]),
    "B2-S4096": (2, 4096, 16, 8, 128, [4095, 1500]),
    "B2-S300-G4": (2, 300, 16, 4, 128, [299, 150]),
    "B3-S100-G8": (3, 100, 16, 2, 128, [99, 0, 52]),
    "B2-S64-G3": (2, 64, 12, 4, 64, [63, 9]),
    "B2-S40-G6": (2, 40, 12, 2, 32, [39, 5]),
    # the talker's heads on one rank of tp = 2 and tp = 4
    "B4-S512-tp2": (4, 512, 8, 4, 128, [0, 511, 200, 37]),
    "B4-S512-tp4": (4, 512, 4, 2, 128, [63, 64, 500, 1]),
}


def _k5_inputs(cuda, dtype, case, seed=3):
    B, S, Hq, Hkv, Dh, pos = K5_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn((B, Hq, Dh), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, S, Hkv, Dh), generator=g, device=cuda).to(dtype)
    v = torch.randn((B, S, Hkv, Dh), generator=g, device=cuda).to(dtype)
    return q, k, v, torch.tensor(pos, device=cuda)


@pytest.mark.parametrize("case", list(K5_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_matches_plain(cuda, dtype, case):
    from qwen3_tts_tpu_torch.ops.kernels import decode_attention as tda
    q, k, v, pos = _k5_inputs(cuda, dtype, case)
    torch.testing.assert_close(tda.decode_attention_cuda(q, k, v, pos),
                               tda.decode_attention_plain(q, k, v, pos),
                               rtol=0, atol=0)


@pytest.mark.parametrize("case", ["B8-S512", "B4-S16"])
def test_decode_attention_kernel_takes_int32_and_int64_pos(cuda, case):
    """The kernel reads pos as it comes (the decode loop keeps int32)."""
    from qwen3_tts_tpu_torch.ops.kernels import decode_attention as tda
    q, k, v, pos = _k5_inputs(cuda, torch.bfloat16, case, seed=6)
    assert torch.equal(tda.decode_attention_cuda(q, k, v, pos.int()),
                       tda.decode_attention_cuda(q, k, v, pos.long()))


@pytest.mark.parametrize("case", ["B8-S512", "B4-S16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_ignores_rows_past_pos(cuda, dtype, case):
    """Rows past pos poisoned to +-99 change no bit of K5's output."""
    from qwen3_tts_tpu_torch.ops.kernels import decode_attention as tda
    q, k, v, pos = _k5_inputs(cuda, dtype, case, seed=8)
    want = tda.decode_attention_cuda(q, k, v, pos)
    for b, p in enumerate(pos.tolist()):
        k[b, p + 1:] = 99.0
        v[b, p + 1:] = -99.0
    assert torch.equal(tda.decode_attention_cuda(q, k, v, pos), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel_matches_plain(cuda, dtype):
    from qwen3_tts_tpu_torch.ops.kernels import paged_attention as tpa
    g = torch.Generator(device=cuda).manual_seed(4)
    B, Hq, Hkv, Dh, P, psz, MAXP = 3, 8, 4, 64, 20, 16, 5
    q = torch.randn((B, Hq, Dh), generator=g, device=cuda).to(dtype)
    pool = torch.randn((2, P, psz, Hkv, Dh), generator=g,
                       device=cuda).to(dtype)
    perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(0))
    table = (perm[:B * MAXP] + 1).reshape(B, MAXP).to(torch.int32).to(cuda)
    table[0, 2:] = 0
    pos = torch.tensor([20, MAXP * psz - 1, 47], device=cuda)
    torch.testing.assert_close(
        tpa.paged_attention_cuda(q, pool[0], pool[1], table, pos),
        tpa.paged_attention_plain(q, pool[0], pool[1], table, pos),
        rtol=0, atol=0)


# K4 cases (B, psz, MAXP, P, pos) at the talker's heads (16 / 8 of 128):
# chunks of ceil(MAXP * psz / 8) that are no multiple of the page (psz
# 64, MAXP 9: chunks of 72; MAXP 40: sub-chunks of 80 rows, staged in
# tiles); row 0 holds one page, its other entries the reserved page 0
K4_CASES = {
    "B1-psz64": (1, 64, 9, 12, [575]),
    "B4-psz64": (4, 64, 9, 37, [0, 575, 300, 64]),
    "B8-psz64": (8, 64, 9, 80, [63, 575, 71, 72, 143, 144, 500, 1]),
    "B1-psz16": (1, 16, 7, 9, [111]),
    "B4-psz16": (4, 16, 7, 30, [15, 111, 13, 14]),
    "B8-psz16": (8, 16, 7, 60, [15, 16, 111, 27, 28, 55, 56, 0]),
    "B2-psz64-MAXP40": (2, 64, 40, 81, [2559, 1000]),
}


@pytest.mark.parametrize("case", list(K4_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel_is_k5_over_gathered_rows(cuda, dtype, case):
    """K4 at error 0 against its plain version and against K5 over the
    rows the table gathers; int32 and int64 pos alike."""
    _check_k4(cuda, dtype, K4_CASES[case], 16, 8)


@pytest.mark.parametrize("case", ["B4-psz64", "B8-psz16"])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel_on_tp_shards(cuda, dtype, tp, case):
    """K4 on one rank of a tp mesh: the talker's 16 / 8 heads split over
    tp, over a dp group's sub-pool; as the whole heads' case."""
    _check_k4(cuda, dtype, K4_CASES[case], 16 // tp, 8 // tp)


def _check_k4(cuda, dtype, case, Hq, Hkv, Dh=128):
    from qwen3_tts_tpu_torch.ops.kernels import decode_attention as tda
    from qwen3_tts_tpu_torch.ops.kernels import paged_attention as tpa
    B, psz, MAXP, P, pl = case
    g = torch.Generator(device=cuda).manual_seed(B * psz)
    q = torch.randn((B, Hq, Dh), generator=g, device=cuda).to(dtype)
    pool = torch.randn((2, P, psz, Hkv, Dh), generator=g,
                       device=cuda).to(dtype)
    perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(B))
    table = (perm[:B * MAXP] + 1).reshape(B, MAXP).to(torch.int32).to(cuda)
    table[0, (pl[0] // psz) + 1:] = 0
    pos = torch.tensor(pl, device=cuda, dtype=torch.int32)
    got = tpa.paged_attention_cuda(q, pool[0], pool[1], table, pos)
    assert got.dtype == dtype
    torch.testing.assert_close(
        got, tpa.paged_attention_plain(q, pool[0], pool[1], table, pos),
        rtol=0, atol=0)
    kv = tpa.paged_gather_kv(pool, table)
    assert torch.equal(got, tda.decode_attention_cuda(
        q, kv[0].contiguous(), kv[1].contiguous(), pos))
    assert torch.equal(got, tpa.paged_attention_cuda(q, pool[0], pool[1],
                                                     table, pos.long()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kv_int8_kernel_matches_plain(cuda, dtype):
    from qwen3_tts_tpu_torch.ops.kernels import kv_int8 as tkv
    g = torch.Generator(device=cuda).manual_seed(5)
    B, Hq, Hkv, Dh, S = 3, 8, 4, 64, 80
    q = torch.randn((B, Hq, Dh), generator=g, device=cuda).to(dtype)
    kq, ks = tkv.quantize_kv_rows(
        torch.randn((B, Hkv, S, Dh), generator=g, device=cuda))
    vq, vs = tkv.quantize_kv_rows(
        torch.randn((B, Hkv, S, Dh), generator=g, device=cuda))
    pos = torch.tensor([0, S - 1, 33], device=cuda)
    args = (q, kq, ks, vq, vs, pos)
    torch.testing.assert_close(tkv.decode_attention_kv_int8_cuda(*args),
                               tkv.decode_attention_kv_int8_plain(*args),
                               rtol=0, atol=0)


# K6 cases (B, S, G, Hkv, Dh, pos): the talker's geometry (G 2, Dh 128,
# the MAIN instantiation) at S 512, ragged chunks (S 577: chunks of 73,
# sub-chunks of 19, scales at offsets off 16 bytes) and S 8192 (staged in
# tiles of 64 rows; the old kernel refused S past ~3900); the generic
# instantiation at G 1, 2 and 8 and Dh 64
K6_CASES = {
    "B3-S80-G2-Dh64": (3, 80, 2, 4, 64, [0, 79, 33]),
    "B1-S512": (1, 512, 2, 8, 128, [511]),
    "B8-S512": (8, 512, 2, 8, 128, [0, 511, 63, 64, 127, 128, 200, 37]),
    "B3-S577": (3, 577, 2, 8, 128, [576, 72, 73]),
    "B8-S577-G1-Dh64": (8, 577, 1, 4, 64, [0, 576, 72, 73, 18, 19, 300, 1]),
    "B3-S512-G8": (3, 512, 8, 2, 128, [511, 0, 64]),
    "B8-S80-G1": (8, 80, 1, 8, 128, [0, 79, 9, 10, 2, 3, 40, 19]),
    "B1-S8192": (1, 8192, 2, 8, 128, [8191]),
    "B3-S8192-G8-Dh64": (3, 8192, 8, 1, 64, [8191, 3000, 1024]),
}


def _k6_inputs(cuda, dtype, case, seed=12):
    from qwen3_tts_tpu_torch.ops.kernels import kv_int8 as tkv
    B, S, G, Hkv, Dh, pos = K6_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn((B, G * Hkv, Dh), generator=g, device=cuda).to(dtype)
    kq, ks = tkv.quantize_kv_rows(
        torch.randn((B, Hkv, S, Dh), generator=g, device=cuda))
    vq, vs = tkv.quantize_kv_rows(
        torch.randn((B, Hkv, S, Dh), generator=g, device=cuda))
    return q, kq, ks, vq, vs, torch.tensor(pos, device=cuda)


@pytest.mark.parametrize("pos_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("case", list(K6_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kv_int8_split_kernel_matches_plain(cuda, dtype, case, pos_dtype):
    """K6 (the int8 mode of K5's split) at error 0 against its plain
    version, K5's plain version over the dequantized rows; equal bits on
    a second launch."""
    from qwen3_tts_tpu_torch.ops.kernels import kv_int8 as tkv
    *args, pos = _k6_inputs(cuda, dtype, case)
    args.append(pos.to(pos_dtype))
    got = tkv.decode_attention_kv_int8_cuda(*args)
    assert got.dtype == dtype
    torch.testing.assert_close(got, tkv.decode_attention_kv_int8_plain(*args),
                               rtol=0, atol=0)
    assert torch.equal(tkv.decode_attention_kv_int8_cuda(*args), got)


def test_kv_int8_kernel_graph_replay(cuda):
    """A CUDA graph of one K6 call replays to the eager output, and reads
    pos at replay: new positions copied into its buffer give the eager
    output at those positions."""
    from qwen3_tts_tpu_torch.ops.kernels import kv_int8 as tkv
    q, kq, ks, vq, vs, pos = _k6_inputs(cuda, torch.bfloat16, "B8-S512")
    want = tkv.decode_attention_kv_int8_cuda(q, kq, ks, vq, vs, pos)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tkv.decode_attention_kv_int8_cuda(q, kq, ks, vq, vs, pos)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    pos.copy_(torch.tensor([5, 300, 511, 0, 64, 63, 1, 400], device=cuda))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, tkv.decode_attention_kv_int8_cuda(q, kq, ks, vq,
                                                              vs, pos))


@pytest.mark.parametrize("case,main", [("B8-S512", True),
                                       ("B3-S80-G2-Dh64", False),
                                       ("B3-S512-G8", False)])
def test_kv_int8_kernel_instantiation(cuda, case, main):
    """The talker's geometry (G 2, Dh 128) launches the MAIN instantiation
    of the int8 mode, other geometries the generic one: the kernel names
    that torch.profiler records for the call."""
    from qwen3_tts_tpu_torch.ops.kernels import kv_int8 as tkv
    args = _k6_inputs(cuda, torch.bfloat16, case)
    tkv.decode_attention_kv_int8_cuda(*args)
    torch.cuda.synchronize()
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        tkv.decode_attention_kv_int8_cuda(*args)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if "decode_attn_split_kernel" in e.key]
    want = f"decode_attn_split_kernel<signed char, {str(main).lower()}, false>"
    assert len(names) == 1 and want in names[0], names


@pytest.mark.parametrize("vec_merged", [False, True])
def test_talker_merged_kernel_matches_plain_and_k3(cuda, vec_merged):
    """K7 (merged weight streams, qsplit reading column blocks with a row
    stride ldw != N) against its plain version and against K3 on the same
    weights, bit for bit."""
    from qwen3_tts_tpu_torch.ops.kernels import talker_merged as tm
    B = 3
    rng = np.random.default_rng(B)
    layers = tm.with_merged(
        quant.quantize_layer_stack(_stack(rng, TGEO, cuda), fuse=True))
    g = torch.Generator(device=cuda).manual_seed(B)
    x = torch.randn((B, TGEO.hidden_size), generator=g,
                    device=cuda).bfloat16()
    kv = torch.randn((TGEO.num_layers, 2, B, 64, 1, TGEO.head_dim),
                     generator=g, device=cuda).bfloat16()
    pos = torch.randint(1, 63, (B,), generator=g, device=cuda)
    cos, sin = tfm.rope_cos_sin(torch.arange(64, device=cuda),
                                TGEO.head_dim, TGEO.rope_theta)
    args = (layers, x, pos, kv, cos, sin, 1e-6, vec_merged)
    h_k, r_k = tm.talker_merged_cuda(*args)
    h_p, r_p = tm.talker_merged_plain(*args)
    h_3, r_3 = tts.talker_step_cuda(layers, x, pos, kv, cos, sin, 1e-6)
    for a, b in ((h_k, h_p), (r_k, r_p), (h_k, h_3), (r_k, r_3)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_streaming_engine_on_the_card(cuda, monkeypatch):
    """Streaming synthesis at tiny geometry on the card (bf16 talker; the
    vocoder in f32, TF32 off), up to 80 tokens, in the window mode (the
    default) and the incremental mode: the codes equal the non-streaming
    (chained) request's, the on_chunk pieces make up the audio, and the
    int16 audio is within +-1 LSB of the non-streaming audio (the
    incremental stream adds up its attention in another order; cuBLAS and
    cuDNN pick their kernels by shape, so another window width rounds
    differently)."""
    from qwen3_tts_tpu_torch import config as pconfig
    from qwen3_tts_tpu_torch.engine.engine import TTSEngine
    eng = TTSEngine(pconfig.tiny_tts_config(max_tokens=80), device=cuda)
    text = "Hello from the port, twice over."
    want = eng.synthesize(text, seed=1)
    for mode in ("window", "incremental"):
        monkeypatch.setenv("QWEN3_TTS_ENGINE_STREAM", mode)
        pieces = []
        res = eng.synthesize(text, seed=1, streaming=True,
                             on_chunk=pieces.append)
        np.testing.assert_array_equal(res.codes, want.codes)
        np.testing.assert_array_equal(np.concatenate(pieces),
                                      res.audio_int16)
        assert res.audio_int16.shape == want.audio_int16.shape
        delta = np.abs(res.audio_int16.astype(np.int32)
                       - want.audio_int16.astype(np.int32))
        assert delta.max() <= 1, (mode, delta.max())
        assert res.first_audio_seconds is not None


# the window stream's windows over 150 codes: (kept tokens [start, end),
# the rows decoded when it is launched, its width): after the head
# chunks of 8 and 56 tokens (the last decoded token is the lookahead,
# rows past it still zero), a tail window once the decode ended, and the
# last tokens
STREAM_WINDOWS = ((0, 7, 8, 64), (7, 63, 64, 64), (63, 127, 150, 128),
                  (127, 150, 150, 192))


@pytest.mark.parametrize("path", ["chained", "window"])
def test_vocoder_windows_full_geometry_on_the_card(cuda, path):
    """The engine's vocoder windows at full vocoder geometry (random
    weights, seed 0) on 150 seeded codes, against synthesize_exact's
    window of voc_bucket(151) = 192 tokens: "chained", one window of the
    widest bucket (320) zero-padded past the codes, as a chained request
    launches it; "window", the window stream's prefix windows
    (STREAM_WINDOWS), each keeping its tokens' samples. int16 within
    chip_smoke.WINDOW_LSB on less than chip_smoke.WINDOW_SHARE of the
    samples (the incremental stream's contract: cuBLAS picks its f32 GEMM
    kernel by the row count, so another width rounds differently)."""
    import chip_smoke
    from qwen3_tts_tpu_torch.config import SAMPLES_PER_TOKEN, VocoderConfig
    from qwen3_tts_tpu_torch.io.weights import init_vocoder_params
    from qwen3_tts_tpu_torch.models import vocoder as voc
    cfg = VocoderConfig()
    dec = voc.int16_decoder(init_vocoder_params(cfg, 0, device=cuda), cfg)
    n, U = 150, SAMPLES_PER_TOKEN
    codes = np.random.default_rng(5).integers(0, 2048, (n, 16)).astype(
        np.int32)
    want = voc.synthesize_exact(dec, codes, device=cuda)
    if path == "chained":
        got = dec(voc.pad_window(codes, voc.VOC_BUCKETS[-1], cuda))
        got = got[0, :n * U].cpu().numpy()
    else:
        got = np.concatenate([
            dec(voc.pad_window(codes[:rows], W, cuda))[
                0, start * U:end * U].cpu().numpy()
            for start, end, rows, W in STREAM_WINDOWS])
    assert got.shape == want.shape == (n * U,)
    delta = np.abs(got.astype(np.int32) - want.astype(np.int32))
    share = float((delta > 0).mean())
    assert delta.max() <= chip_smoke.WINDOW_LSB, (delta.max(), share)
    assert share < chip_smoke.WINDOW_SHARE, share


def test_int8_cp_engine_and_prefix_cache_on_the_card(cuda):
    """At full geometry: the int8-cp engine's code predictor launches K2
    at every step and replays its prelude (the 2-token prefill on K1) as
    a CUDA graph, whose replays count their K1 launches; its dense
    talker never launches K3; a request that hits the prefix cache after
    another request gives the cold request's codes."""
    from qwen3_tts_tpu_torch.config import TTSConfig
    from qwen3_tts_tpu_torch.engine.engine import TTSEngine
    eng = TTSEngine(TTSConfig(max_tokens=24), quantize="int8-cp",
                    device=cuda)
    assert eng.quantize == "int8-cp"
    k2, k3, k1 = (tcp.cp_decode_steps.launches,
                  tts.talker_decode_step_fused.launches, tqm.qmatmul.launches)
    replays = _cp_graph_counts()[1]
    cold = eng.synthesize("Привет, мир!", seed=3)
    assert cold.n_tokens > 0
    steps = tcp.cp_decode_steps.launches - k2
    assert steps >= cold.n_tokens
    assert _cp_graph_counts()[1] - replays == steps
    assert tqm.qmatmul.launches - k1 >= 21 * steps
    k1, k2 = tqm.qmatmul.launches, tcp.cp_decode_steps.launches
    assert tts.talker_decode_step_fused.launches == k3
    eng.synthesize("Another request.", seed=1)
    hit = eng.synthesize("Привет, мир!", seed=3)
    assert len(eng._prefix_cache) == 2
    np.testing.assert_array_equal(hit.codes, cold.codes)
    np.testing.assert_array_equal(hit.audio_int16, cold.audio_int16)
    assert tts.talker_decode_step_fused.launches == k3
    assert tqm.qmatmul.launches - k1 >= 21 * (
        tcp.cp_decode_steps.launches - k2)
    assert _cp_graph_counts()[1] - replays == (
        tcp.cp_decode_steps.launches - k2 + steps)


def test_safetensors_read_to_the_card_equals_the_host(cuda, tmp_path):
    """io/safetensors.read_safetensors(device="cuda") gives the host's
    tensors, dtypes (bf16 kept) and bits."""
    from qwen3_tts_tpu_torch.io.safetensors import read_safetensors
    import chip_smoke
    g = torch.Generator().manual_seed(0)
    tensors = {"bf16": torch.randn(33, 17, generator=g).to(torch.bfloat16),
               "f32": torch.randn(5, 3, 7, generator=g),
               "i64": torch.arange(9), "i8": torch.arange(-4, 4).to(
                   torch.int8), "scalar": torch.tensor(1.5)}
    path = str(tmp_path / "x.safetensors")
    chip_smoke.write_safetensors(path, tensors)
    host = read_safetensors(path)
    card = read_safetensors(path, device=cuda)
    assert set(host) == set(card) == set(tensors)
    for k, t in tensors.items():
        assert card[k].device.type == "cuda" and card[k].dtype == t.dtype
        assert torch.equal(card[k].cpu(), host[k]) and torch.equal(host[k], t)


def test_encoder_on_the_card_matches_the_host(cuda):
    """The FP32 encoder (TF32 off) at the tiny geometry on the card:
    latents within 1e-4 of the host's scale (chip_smoke.py's bound at
    the full geometry), and the host's RVQ codes
    except for counted near ties (chip_smoke._rvq_flips: the two rows'
    distances within 1e-5 relative)."""
    import chip_smoke
    from qwen3_tts_tpu_torch import config as pconfig
    from qwen3_tts_tpu_torch.io import weights as tweights
    from qwen3_tts_tpu_torch.models import encoder as tenc
    cfg = pconfig.tiny_tts_config()
    ep = tenc.init_encoder_params(cfg.encoder, seed=1)
    vp = tweights.init_vocoder_params(cfg.vocoder, seed=2)
    wav = torch.from_numpy((np.random.default_rng(3).standard_normal(
        (1, 1920 * 12)) * 0.1).astype(np.float32))
    tree = tweights.to_device({"encoder": ep, "vocoder": vp}, cuda)
    z_host = tenc.encode_features(ep, wav, cfg.encoder)
    z_card = tenc.encode_features(tree["encoder"], wav.to(cuda),
                                  cfg.encoder).cpu()
    scale = float(z_host.abs().max())
    assert float((z_card - z_host).abs().max()) <= 1e-4 * scale
    cb = tenc.decoder_codebooks(vp, cfg.vocoder)
    got = tenc.rvq_encode(tenc.decoder_codebooks(tree["vocoder"], cfg.vocoder),
                          z_card.to(cuda))[0].cpu().numpy()
    want = tenc.rvq_encode(cb, z_host)[0].numpy()
    chip_smoke._rvq_flips(got, want, z_host[0].numpy(), cb.numpy())


@pytest.mark.parametrize("paged", [False, True])
def test_batcher_depth2_equals_depth1_on_the_card(cuda, paged):
    """The bf16 batcher at full width and a depth of 2 talker layers
    (the int8 code predictor at full geometry, K2), dense under
    attention_impl="pallas" (K5) or paged with pages of 64 (K4): six
    requests through 4 slots, two of them streaming, give at
    pipeline_depth=2 the codes and int16 audio of pipeline_depth=1 bit
    for bit, and the attention kernel of the mode launches."""
    from qwen3_tts_tpu_torch.config import TalkerConfig, TTSConfig
    from qwen3_tts_tpu_torch.io.weights import init_random_params
    from qwen3_tts_tpu_torch.ops.kernels.decode_attention import (
        decode_attention)
    from qwen3_tts_tpu_torch.ops.kernels.paged_attention import (
        paged_decode_attention)
    from qwen3_tts_tpu_torch.serve.batching import ContinuousBatcher
    cfg = TTSConfig(talker=TalkerConfig(num_layers=2,
                                        attention_impl="pallas"),
                    max_tokens=40)
    params = init_random_params(cfg, seed=0, dtype=torch.bfloat16,
                                device=cuda)
    att = paged_decode_attention if paged else decode_attention
    kw = dict(paged=True, page_size=64) if paged else {}
    rng = np.random.default_rng(0)
    texts = [rng.integers(1, 1000, n).astype(np.int32)
             for n in (5, 9, 3, 12, 7, 4)]
    out = {}
    for depth in (1, 2):
        b = ContinuousBatcher(cfg, params, batch_size=4, decode_chunk=8,
                              pipeline_depth=depth, device=cuda, **kw)
        before = (att.launches, tcp.cp_decode_steps.launches)
        futs = [b.submit(ids, len(ids), seed=i,
                         on_chunk=(lambda s: None) if i in (1, 4) else None)
                for i, ids in enumerate(texts)]
        for _ in range(400):
            if all(f.done() for f in futs):
                break
            b.step()
        out[depth] = [f.result(timeout=0) for f in futs]
        assert att.launches > before[0]
        assert tcp.cp_decode_steps.launches > before[1]
        assert all(r is None for r in b._slot_req)
    for (c1, a1), (c2, a2) in zip(out[1], out[2]):
        assert len(c1) > 0 and len(a1) == len(c1) * 1920
        np.testing.assert_array_equal(c1, c2)
        np.testing.assert_array_equal(a1, a2)


def test_mesh_over_nccl_on_four_cards(cuda, tmp_path):
    """dp 2 x tp 2 on four cards, rank r on cuda:r (NCCL for the tp
    collectives, gloo for the batcher's host status; ranks of
    tests/torch_mesh_worker.py): the dense and paged batchers in f32,
    greedy, at a small geometry of 8 heads and 4 kv heads give every
    request the codes of one card without a mesh, and each request is
    served by one rank."""
    import dataclasses
    import os
    import sys
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_mesh_worker as W
    from qwen3_tts_tpu_torch import config as C
    from qwen3_tts_tpu_torch.io import weights as tw
    from qwen3_tts_tpu_torch.serve.batching import ContinuousBatcher
    base = C.tiny_tts_config(max_tokens=8)
    cfg = dataclasses.replace(
        base, talker=dataclasses.replace(base.talker, num_heads=8,
                                         num_kv_heads=4, max_seq_len=64),
        code_predictor=dataclasses.replace(base.code_predictor,
                                           num_heads=8, num_kv_heads=4),
        sampling=C.SamplingConfig(temperature=0.0, repetition_penalty=1.0,
                                  cp_temperature=0.0))
    params = tw.init_random_params(cfg, seed=0, dtype=torch.float32)
    tw.save_pytree_npz(str(tmp_path / "params.npz"), params, config=cfg)
    reqs = [(np.asarray((np.arange(4 + i % 3) * 7 + i * 13) % 997,
                        np.int32), 4 + i % 3, 100 + i) for i in range(6)]
    W.write_schedule(str(tmp_path / "in.npz"), reqs, batch=4,
                     quantize_cp=False, stream=2)
    outs = W.run_ranks("batcher", 2, 2, str(tmp_path), timeout=300,
                       device="cuda")
    for tag, paged in (("dense", False), ("paged", True)):
        b = ContinuousBatcher(cfg, params, batch_size=4, decode_chunk=4,
                              dtype=torch.float32, device="cuda",
                              paged=paged, page_size=16, quantize_cp=False)
        futs = [b.submit(ids, n, seed=s) for ids, n, s in reqs]
        while not all(f.done() for f in futs):
            b.step()
        served = {i: o for o in outs for i in o[f"{tag}_owned"].tolist()}
        assert sorted(served) == list(range(len(reqs)))
        for i, f in enumerate(futs):
            np.testing.assert_array_equal(served[i][f"{tag}_codes{i}"],
                                          f.result()[0])



def test_daemon_dp2_tp2_over_nccl_on_four_cards(cuda, tmp_path):
    """``daemon --batch 4 --tp 2 --dp 2`` on four cards (its own four
    ranks, rank r on cuda:r, NCCL for the tp collectives; serve/
    lockstep.py's rank-0 front end): it reports the mesh, serves a blob
    and a stream, and drains on SIGTERM; the blob's audio and the
    stream's frames equal the lockstep ContinuousBatcher(mesh=...) driven
    directly on the same mesh (tests/torch_mesh_worker.py) with the same
    submissions, weights and seeds."""
    import os
    import signal
    import subprocess
    import sys
    import time
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_mesh_worker as W
    from qwen3_tts_tpu_torch import config as C
    from qwen3_tts_tpu_torch.engine.engine import TTSEngine
    from qwen3_tts_tpu_torch.io import weights as tw
    from qwen3_tts_tpu_torch.serve.daemon import DaemonClient
    cfg = C.tiny_tts_config(max_tokens=32)        # the daemon's --tiny
    params = tw.init_random_params(cfg, seed=0, dtype=torch.float32)
    tw.save_pytree_npz(str(tmp_path / "params.npz"), params, config=cfg)
    texts = (("four card blob", 3), ("four card stream", 5))
    eng = TTSEngine(cfg, params=params, dtype=torch.float32, device="cpu")
    reqs = [(*eng._encode_text(t), s) for t, s in texts]
    W.write_schedule(str(tmp_path / "in.npz"), reqs, batch=4, stream=1)
    outs = W.run_ranks("batcher", 2, 2, str(tmp_path), timeout=300,
                       device="cuda")
    served = {i: o for o in outs for i in o["dense_owned"].tolist()}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sock = str(tmp_path / "d.sock")
    proc = subprocess.Popen(
        [sys.executable, "-m", "qwen3_tts_tpu_torch.serve.daemon", "--tiny",
         "--dtype", "float32", "--model_dir", str(tmp_path), "--batch", "4",
         "--tp", "2", "--dp", "2", "--decode_chunk", "4", "--python_loop",
         "--socket", sock], cwd=root, env=dict(os.environ, PYTHONPATH=root),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        deadline = time.time() + 300
        while not os.path.exists(sock):
            assert proc.poll() is None, proc.stdout.read().decode(
                errors="replace")
            assert time.time() < deadline, "the socket never appeared"
            time.sleep(0.1)
        client = DaemonClient(sock)
        hdr, blob = client.synthesize(texts[0][0], seed=texts[0][1])
        frames = []
        shdr, streamed = client.synthesize(
            texts[1][0], seed=texts[1][1], stream=True,
            on_chunk=lambda h, a: frames.append(a) if "chunk" in h else None)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
        log = out.decode(errors="replace")
        assert proc.returncode == 0, log[-4000:]
        assert "mesh dp2xtp2 over 4 device(s)" in log
        assert not os.path.exists(sock)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert hdr["n_tokens"] == len(served[0]["dense_codes0"]) > 0
    np.testing.assert_array_equal(blob, served[0]["dense_audio0"])
    assert shdr["n_tokens"] == len(served[1]["dense_codes1"]) > 0
    np.testing.assert_array_equal(np.concatenate(frames),
                                  served[1]["dense_segments"])
    np.testing.assert_array_equal(streamed, served[1]["dense_audio1"])


# the int8 tier's least teacher-forced hidden cosine against bf16 at full
# geometry, random weights (seed 0): the first chip run measured 0.99929
# over chip_smoke's three texts at 32 greedy steps (PERF.md section 6),
# so at least that on their first text's first 16 steps; the bound sits
# below it
QUALITY_TF_COS_BOUND = 0.999


def test_quality_dossier_int8_full_geometry_on_the_card(cuda):
    """The int8 dossier (qwen3_tts_tpu_torch/tools/quality_check.py) at
    full geometry on the card, through the served kernels (K3, K2, K1):
    the teacher-forced hidden drift of the int8 talker stays above the
    bound; the lengths match."""
    import dataclasses
    from qwen3_tts_tpu_torch.config import TTSConfig
    from qwen3_tts_tpu_torch.io.weights import init_random_params
    from qwen3_tts_tpu_torch.ops.kernels.talker_step import (
        talker_decode_step_fused)
    from qwen3_tts_tpu_torch.tools import quality_check as qc
    cfg = qc.greedy_config(dataclasses.replace(TTSConfig(), max_tokens=16))
    params = init_random_params(TTSConfig(), seed=0, dtype=torch.bfloat16,
                                device="cuda")
    before = talker_decode_step_fused.launches
    rep = qc.run_dossier(cfg, params, ["int8"], texts=["Привет, мир!"],
                         seed=0, n_hidden_steps=16, device="cuda")["int8"]
    assert talker_decode_step_fused.launches > before
    assert rep["tf_cos_min"] >= QUALITY_TF_COS_BOUND, rep
    assert 0.0 <= rep["tf_code0_agree"] <= 1.0, rep
