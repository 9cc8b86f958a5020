"""K1's two routes and its grouped entry point, on the CPU: the route is a
function of the shape alone (decode rows on qsplit, everything else on
the tensor-core tile), ``quant.matmul_group`` gives the bits of one
``qmatmul_plain`` a weight and launches no kernel, and the tile's
normalised-error bound (``qmatmul_error``) passes qmm's f32 rounding and
fails a wrong column. The routes themselves run only on the card
(tests/test_torch_cuda.py holds qsplit to qmatmul_plain bit for bit and
the tile to the bound). Inputs are drawn with numpy from fixed seeds.
"""

import numpy as np
import pytest
import torch

from qwen3_tts_tpu_torch.models import transformer as ttfm
from qwen3_tts_tpu_torch.ops import quant as tquant
from qwen3_tts_tpu_torch.ops.kernels import qmatmul as tqm

torch.set_num_threads(1)


def _weights(rng, K, Ns):
    return [tquant.quantize_int8(torch.from_numpy(
        (rng.standard_normal((K, N)) * 0.05).astype(np.float32)))
        for N in Ns]


@pytest.mark.parametrize("M,K,Ns,want", [
    (1, 1024, [3072], True),             # codec_head
    (2, 1024, [2048, 1024, 1024], True),  # the CP prefill's q|k|v
    (8, 1024, [3072, 3072], True),       # gate|up at 8 rows
    (2, 3072, [1024], True),             # down
    (9, 1024, [4096], False),            # past 8 rows: prefill
    (73, 1024, [4096], False),           # the talker prefill
    (1, 1024, [1032], False),            # N not a multiple of 16
    (1, 1024, [1024] * 4, False),        # more than three weights
    (1, 4096, [1024], False),            # K past the shared memory
    (1, 1020, [1024], False),            # K not a multiple of 8
])
def test_route_is_chosen_by_shape(M, K, Ns, want):
    assert tqm.on_qsplit(M, K, Ns) is want


@pytest.mark.parametrize("M,K,N,want", [
    (1, 1024, 3072, "qsplit"),           # codec_head
    (8, 3072, 1024, "qsplit"),           # down at 8 rows
    (9, 1024, 1024, "tile"),             # past 8 rows
    (41, 1024, 4096, "tile"),            # the slice's talker prefill q|k|v
    (41, 2048, 1024, "tile"),            # o
    (41, 1024, 6144, "tile"),            # gate|up
    (41, 3072, 1024, "tile"),            # down
    (265, 1024, 4096, "tile"),           # the largest text bucket
    (1, 1024, 1032, "tile"),             # N not a multiple of 16
    (1, 4096, 1024, "tile"),             # K past qsplit's shared memory
    (1, 1032, 1024, "qsplit"),           # K % 16 != 0 but on qsplit
])
def test_each_weight_goes_to_a_route_by_shape(M, K, N, want):
    assert tqm.route(M, K, N) == want


@pytest.mark.parametrize("M,K,N", [
    (41, 1020, 4096),                    # K % 16 != 0 past 8 rows
    (1, 1020, 1024),                     # K % 8 != 0
    (41, 1024, 1020),                    # N % 8 != 0
])
def test_a_shape_no_route_takes_raises(M, K, N):
    with pytest.raises(ValueError):
        tqm.route(M, K, N)


def _k1_case(seed, M, K, N):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    q = torch.from_numpy(rng.integers(-127, 128, (K, N)).astype(np.int8))
    s = torch.from_numpy((rng.random(N) * 0.01 + 1e-3).astype(np.float32))
    return x, q, s


@pytest.mark.parametrize("K", [1024, 3072])
def test_qmm_is_within_the_tile_bound(K):
    """qmm's f32 accumulation at the slice's R = 41 sits ~300x inside the
    2^-16 bound the tile is held to: the bound is about rounding only."""
    x, q, s = _k1_case(0, 41, K, 256)
    err = tqm.qmatmul_error(tqm.qmatmul_plain(x, q, s), x, q, s)
    assert err <= tqm.TILE_TOL / 100


@pytest.mark.parametrize("fault", ["swapped columns", "dropped k-slab",
                                   "shifted row"])
def test_tile_bound_catches_a_wrong_product(fault):
    """Two columns swapped, a 64-row slab of K dropped or the rows shifted
    by one: 1e-2 or more, far past the 2^-16 bound."""
    x, q, s = _k1_case(0, 41, 1024, 256)
    if fault == "swapped columns":
        bad = q.clone()
        bad[:, [3, 7]] = q[:, [7, 3]]
        out = tqm.qmatmul_plain(x, bad, s)
    elif fault == "dropped k-slab":
        bad = q.clone()
        bad[64:128] = 0
        out = tqm.qmatmul_plain(x, bad, s)
    else:
        out = torch.roll(tqm.qmatmul_plain(x, q, s), 1, dims=0)
    assert tqm.qmatmul_error(out, x, q, s) > 1e-2


def test_tile_bound_reads_bf16_rows_and_zero_rows():
    """bf16 x and an all-zero row: the exact product of a zero row has no
    error, and the bound takes x rounded to bf16 as the kernel does."""
    x, q, s = _k1_case(3, 9, 64, 32)
    x[4] = 0
    xb = x.to(torch.bfloat16)
    out = tqm.qmatmul_plain(xb, q, s)
    assert out[4].abs().max() == 0
    assert tqm.qmatmul_error(out, xb, q, s) <= tqm.TILE_TOL / 100
    assert tqm.qmatmul_error(out, x, q, s) <= tqm.TILE_TOL / 100


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Ns", [[64, 32], [64, 32, 32]],
                         ids=["2-segments", "3-segments"])
def test_matmul_group_is_one_plain_product_a_weight(Ns, dtype):
    """(2, 3, K) rows, leading dims kept; no K1 launch on the CPU."""
    rng = np.random.default_rng(len(Ns))
    K = 256
    ws = _weights(rng, K, Ns)
    x = torch.from_numpy(rng.standard_normal((2, 3, K)).astype(np.float32)
                         ).to(dtype)
    before = (tqm.qmatmul.launches, tqm.qmatmul_qsplit.launches,
              tqm.qmatmul_tile.launches)
    got = tquant.matmul_group(x, ws)
    assert (tqm.qmatmul.launches, tqm.qmatmul_qsplit.launches,
            tqm.qmatmul_tile.launches) == before
    assert len(got) == len(ws)
    for g, w in zip(got, ws):
        want = tqm.qmatmul_plain(x.reshape(6, K), w.q, w.scale)
        assert g.shape == (2, 3, w.q.shape[1]) and g.dtype == torch.float32
        assert torch.equal(g.reshape(6, -1), want)
        assert torch.equal(g, tquant.matmul(x, w))


def test_matmul_group_of_dense_weights_is_one_matmul_a_weight():
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((3, 32)).astype(np.float32))
    ws = [torch.from_numpy(rng.standard_normal((32, n)).astype(np.float32))
          for n in (16, 8)]
    for g, w in zip(tquant.matmul_group(x, ws), ws):
        assert torch.equal(g, tquant.matmul(x, w))


def test_unfused_int8_layer_products_are_unchanged_by_grouping():
    """The transformer's unfused q|k|v and gate|up (the code predictor's
    layout) through matmul_group equal one product a weight."""
    rng = np.random.default_rng(11)
    H, I, Hq, Hkv, Dh = 64, 96, 4, 2, 16
    geo = ttfm.TransformerGeometry(
        num_layers=1, hidden_size=H, intermediate_size=I, num_heads=Hq,
        num_kv_heads=Hkv, head_dim=Dh, rms_norm_eps=1e-6, rope_theta=1e6)
    q_w, k_w, v_w = _weights(rng, H, [Hq * Dh, Hkv * Dh, Hkv * Dh])
    gate, up = _weights(rng, H, [I, I])
    (down,) = _weights(rng, I, [H])
    layer = {"q_proj": q_w, "k_proj": k_w, "v_proj": v_w,
             "q_norm": torch.ones(Dh), "k_norm": torch.ones(Dh)}
    x = torch.from_numpy(rng.standard_normal((1, 2, H)).astype(np.float32)
                         ).bfloat16()
    cos, sin = ttfm.rope_cos_sin(torch.arange(2)[None], Dh, 1e6)
    q, k, v = ttfm._qkv(layer, x, geo, cos, sin)
    xf = x.reshape(2, H)
    assert torch.equal(v.reshape(2, -1),
                       tquant.matmul(xf, v_w).to(torch.bfloat16))
    want_q = tquant.matmul(xf, q_w).to(torch.bfloat16).reshape(1, 2, Hq, Dh)
    want_q = ttfm.apply_rope(ttfm.rms_norm(want_q, layer["q_norm"], 1e-6),
                             cos[:, :, None, :], sin[:, :, None, :])
    assert torch.equal(q, want_q)
    got = ttfm.swiglu_mlp(x, gate, up, down)
    h = (ttfm.silu(tquant.matmul(x, gate)) * tquant.matmul(x, up)).to(x.dtype)
    assert torch.equal(got, tquant.matmul(h, down).to(x.dtype))
