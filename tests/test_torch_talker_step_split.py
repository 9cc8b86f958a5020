"""K3's attention split over a cluster (qwen3_tts_tpu_torch/csrc/
talker_step.cu) through its plain version, on the CPU: the whole step
against the JAX package's talker_decode_step_fused (interpret mode) at
positions on the chunk edges, the split attention alone against a float64
softmax with p rounded to bf16, the 128-thread RMS sum against the
512-thread one, and the step over K7's strided views against the dense
layers. Inputs are drawn with numpy from fixed seeds, at the tiny
geometry of tests/test_torch_kernels.py (hidden 256, 2 query heads over
1 KV head of 128, 2 layers).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qwen3_tts_tpu.models import transformer as jtfm
from qwen3_tts_tpu.ops import quant as jquant
from qwen3_tts_tpu.ops.pallas.talker_step import talker_decode_step_fused
from qwen3_tts_tpu_torch.io.weights import from_jax_numpy
from qwen3_tts_tpu_torch.ops.kernels import talker_merged as tm
from qwen3_tts_tpu_torch.ops.kernels import talker_step as tts
from qwen3_tts_tpu_torch.ops.kernels.common import (ATT_THREADS, _pad_last,
                                                    bf16, block_sum,
                                                    rms_heads)

torch.set_num_threads(1)

TGEO = jtfm.TransformerGeometry(
    num_layers=2, hidden_size=256, intermediate_size=256, num_heads=2,
    num_kv_heads=1, head_dim=128, rms_norm_eps=1e-6, rope_theta=1e6)
S = 32                       # chunks of C = ceil(32 / 8) = 4 positions
C = -(-S // tts.NSPLIT)
# positions on the chunk edges: 0, C - 1, C, S - 1
EDGES = {"B1-first": [0], "B1-last": [S - 1],
         "B8-edges": [0, C - 1, C, S - 1, 1, 2 * C - 1, 2 * C, 17]}


def _stack(rng, geo, scale=0.02):
    """A float32 layer stack drawn from numpy (JAX init shapes)."""
    L, H, I = geo.num_layers, geo.hidden_size, geo.intermediate_size
    QD, KVD = geo.num_heads * geo.head_dim, geo.num_kv_heads * geo.head_dim

    def w(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def norm(*shape):
        return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)

    return {"input_ln": norm(L, H), "post_ln": norm(L, H),
            "q_norm": norm(L, geo.head_dim), "k_norm": norm(L, geo.head_dim),
            "q_proj": w(L, H, QD), "k_proj": w(L, H, KVD),
            "v_proj": w(L, H, KVD), "o_proj": w(L, QD, H),
            "gate_proj": w(L, H, I), "up_proj": w(L, H, I),
            "down_proj": w(L, I, H)}


def _port(tree):
    """JAX params -> the port's layer dict (QTensors as (q, scale))."""
    out = {k: ((np.asarray(v.q), np.asarray(v.scale))
               if isinstance(v, jquant.QTensor) else np.asarray(v))
           for k, v in tree.items()}
    return from_jax_numpy({"c": out})["c"]


@pytest.fixture(scope="module")
def fused():
    rng = np.random.default_rng(0)
    return jquant.quantize_layer_stack(
        jax.tree.map(jnp.asarray, _stack(rng, TGEO)), fuse=True)


def _step_inputs(pos, seed):
    rng = np.random.default_rng(seed)
    B = len(pos)
    x = (rng.standard_normal((B, TGEO.hidden_size)) * 0.3).astype(np.float32)
    kv = (rng.standard_normal((TGEO.num_layers, 2, B, S, TGEO.num_kv_heads,
                               TGEO.head_dim)) * 0.2).astype(np.float32)
    cos, sin = jtfm.rope_cos_sin(jnp.arange(S, dtype=jnp.int32),
                                 TGEO.head_dim, 1e6)
    return x, kv, np.asarray(pos, np.int32), cos, sin


@pytest.mark.parametrize("case", sorted(EDGES))
def test_split_step_matches_pallas_on_chunk_edges(fused, case):
    """(a) The plain K3 (split attention) against the TPU kernel in
    interpret mode. Tolerance as tests/test_torch_kernels.py's K3 tests
    (rtol 1e-2, atol 5e-3): the same op order, so only the f32 summation
    order differs, and with it a one-ulp bf16 rounding flip here and
    there, which two layers carry into h."""
    x, kv, pos, cos, sin = _step_inputs(EDGES[case], seed=len(EDGES[case]))
    want_h, want_kv = talker_decode_step_fused(
        fused, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(kv), cos, sin,
        eps=TGEO.rms_norm_eps, interpret=True)
    got_h, got_kv = tts.talker_decode_step_fused(
        _port(fused), torch.from_numpy(x), torch.from_numpy(pos),
        torch.from_numpy(kv.copy()), torch.from_numpy(np.array(cos)),
        torch.from_numpy(np.array(sin)), eps=TGEO.rms_norm_eps)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h),
                               rtol=1e-2, atol=5e-3)
    b_idx = np.arange(len(pos))
    np.testing.assert_allclose(got_kv.numpy()[:, :, b_idx, pos],
                               np.asarray(want_kv)[:, :, b_idx, pos],
                               rtol=1e-2, atol=5e-3)


def _f64_attention(q, K, V, pos, scale):
    """softmax(q . K * scale) over s <= pos in float64, p rounded to bf16
    (as the TPU kernel rounds it), then P.V in float64. Returns the output
    and sum_s p_s |v_s| (the scale of a bf16 flip of p)."""
    q, K, V = (np.asarray(t, np.float64) for t in (q, K, V))
    B, nKV, G, Dh = q.shape
    out = np.zeros((B, nKV, G, Dh))
    mag = np.zeros_like(out)
    for b in range(B):
        n = int(pos[b]) + 1
        for h in range(nKV):
            sc = q[b, h] @ K[b, :n, h].T * scale              # (G, n)
            e = np.exp(sc - sc.max(-1, keepdims=True))
            p = bf16(torch.from_numpy(e / e.sum(-1, keepdims=True))
                     .float()).double().numpy()
            out[b, h] = p @ V[b, :n, h]
            mag[b, h] = p @ np.abs(V[b, :n, h])
    return out, mag


@pytest.mark.parametrize("S_,pos", [(32, [0, 3, 4, 31]), (30, [29, 4, 11]),
                                    (512, [511, 63, 64, 0, 200])])
def test_split_attention_matches_f64_softmax(S_, pos):
    """(b) The plain split attention against a float64 softmax with p
    rounded to bf16. Bound: each p may sit one bf16 ulp (2^-8 relative)
    from the float64 path's where their f32 and f64 values round to
    different sides, so |got - ref| <= 2^-8 sum_s p_s |v_s|, plus 1e-5
    for the f32 sums."""
    rng = np.random.default_rng(S_)
    B, nKV, G, Dh = len(pos), 2, 2, 64
    q = bf16(torch.from_numpy(rng.standard_normal((B, nKV, G, Dh))
                              .astype(np.float32)))
    K = bf16(torch.from_numpy(rng.standard_normal((B, S_, nKV, Dh))
                              .astype(np.float32)))
    V = bf16(torch.from_numpy(rng.standard_normal((B, S_, nKV, Dh))
                              .astype(np.float32)))
    p = torch.tensor(pos)
    scale = 1.0 / Dh ** 0.5
    got = tts.split_attention(q, K, V, p, scale).numpy()
    ref, mag = _f64_attention(q, K, V, pos, scale)
    assert np.all(np.abs(got - ref) <= 2.0 ** -8 * mag + 1e-5)


@pytest.mark.parametrize("Dh", [32, 64, 128])
def test_rms_heads_128_threads_bit_equal_512(Dh):
    """(c) The per-head RMS over a 128-thread block (the K3 attention
    kernel's: 32-lane trees added in order) against rms_heads, whose sum
    runs over a 512-thread block_sum, bit for bit: the extra warps add
    zeros."""
    rng = np.random.default_rng(Dh)
    x = torch.from_numpy((rng.standard_normal((8, 16, Dh))
                          * np.exp(rng.standard_normal((8, 16, 1)) * 3))
                         .astype(np.float32))
    w = torch.from_numpy((1 + 0.1 * rng.standard_normal(Dh))
                         .astype(np.float32))
    ss = block_sum(_pad_last(x * x, 128))
    assert torch.equal(ss, block_sum(_pad_last(x * x, ATT_THREADS)))
    rms128 = x * (1.0 / torch.sqrt(ss / Dh + 1e-6))[..., None] * w
    assert torch.equal(rms128, rms_heads(x, w, 1e-6))


@pytest.mark.parametrize("vec_merged", [False, True])
def test_step_on_merged_views_bit_equal_dense(fused, vec_merged):
    """(d) talker_step_plain over K7's strided views of the merged blocks
    against the dense layers, bit for bit, at B = 8 on the chunk edges."""
    layers = tm.with_merged(_port(fused))
    x, kv, pos, cos, sin = _step_inputs(EDGES["B8-edges"], seed=3)
    args = (torch.from_numpy(x), torch.from_numpy(pos),
            torch.from_numpy(kv), torch.from_numpy(np.array(cos)),
            torch.from_numpy(np.array(sin)), TGEO.rms_norm_eps)
    h_v, r_v = tts.talker_step_plain(tm.merged_views(layers, vec_merged),
                                     *args)
    h_d, r_d = tts.talker_step_plain(layers, *args)
    assert torch.equal(h_v, h_d) and torch.equal(r_v, r_d)
