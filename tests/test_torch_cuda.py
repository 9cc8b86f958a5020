"""The port's CUDA kernels against their plain PyTorch versions, on the
card, at small shapes. Each plain version adds up in its kernel's order,
so kernel and plain version must agree bit for bit.

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


@pytest.mark.parametrize("M", [1, 2, 73])
def test_qmatmul_kernel_matches_plain(cuda, M):
    g = torch.Generator(device=cuda).manual_seed(M)
    x = torch.randn((M, 1024), generator=g, device=cuda).bfloat16()
    q = torch.randint(-127, 128, (1024, 3072), generator=g, device=cuda,
                      dtype=torch.int8)
    s = torch.rand((3072,), generator=g, device=cuda) * 0.01 + 1e-3
    torch.testing.assert_close(tqm.qmatmul(x, q, s),
                               tqm.qmatmul_plain(x, q, s), rtol=0, atol=0)


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
            tqm.qmatmul_qmm.launches)


# (M, K, N, x dtype, route): decode rows on qsplit at the CP prefill's and
# the heads' widths, f32 rows too; 73 rows and an N off 16 on the qmm tile
K1_ROUTES = [(M, 1024, 3072, torch.bfloat16, "qsplit") for M in range(1, 9)]
K1_ROUTES += [(2, 2048, 1024, torch.bfloat16, "qsplit"),
              (2, 3072, 1024, torch.float32, "qsplit"),
              (4, 1024, 2048, torch.float32, "qsplit"),
              (73, 1024, 4096, torch.bfloat16, "qmm"),
              (9, 1024, 1024, torch.float32, "qmm"),
              (1, 1024, 1032, torch.bfloat16, "qmm")]


@pytest.mark.parametrize("M,K,N,dtype,route", K1_ROUTES)
def test_qmatmul_routes_match_plain(cuda, M, K, N, dtype, route):
    """Each route at error 0 against qmatmul_plain, one launch on the
    route the shape picks."""
    x, [(q, s)] = _k1_case(cuda, M + N, M, K, [N], dtype)
    before = _k1_counts()
    got = tqm.qmatmul(x, q, s)
    a, b, c = (n - m for n, m in zip(_k1_counts(), before))
    assert (a, b, c) == ((1, 1, 0) if route == "qsplit" else (1, 0, 1))
    torch.testing.assert_close(got, tqm.qmatmul_plain(x, q, s), rtol=0,
                               atol=0)


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


def test_qmatmul_group_qsplit_refuses_runs_one_launch_a_weight(cuda):
    """A group at prefill rows: one qmm-tile launch a weight."""
    x, ws = _k1_case(cuda, 5, 12, 1024, [1024, 2048])
    before = _k1_counts()
    outs = tqm.qmatmul_group(x, ws)
    assert tuple(n - m for n, m in zip(_k1_counts(), before)) == (2, 0, 2)
    for o, (q, s) in zip(outs, ws):
        torch.testing.assert_close(o, tqm.qmatmul_plain(x, q, s), rtol=0,
                                   atol=0)


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
    from qwen3_tts_tpu_torch.ops.kernels import decode_attention as tda
    from qwen3_tts_tpu_torch.ops.kernels import paged_attention as tpa
    B, psz, MAXP, P, pl = K4_CASES[case]
    Hq, Hkv, Dh = 16, 8, 128
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
