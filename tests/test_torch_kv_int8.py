"""K6, the int8-KV decode attention of the port
(qwen3_tts_tpu_torch/ops/kernels/kv_int8.py), and the port of its tool
(qwen3_tts_tpu_torch/tools/bench_kv_int8.py) against the JAX package on
the CPU: the port runs K6's plain version, the JAX side its Pallas kernel
in interpret mode (as tests/test_kv_int8.py does). Inputs are drawn with
numpy from fixed seeds; each test states its tolerance.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qwen3_tts_tpu import config as C
from qwen3_tts_tpu.models import transformer as jtfm
from qwen3_tts_tpu.ops import quant as jquant
from qwen3_tts_tpu.ops.pallas import kv_int8 as jkv
from qwen3_tts_tpu_torch import config as pconfig
from qwen3_tts_tpu_torch.models import transformer as ttfm
from qwen3_tts_tpu_torch.ops.kernels import kv_int8 as tkv
from qwen3_tts_tpu_torch.tools import bench_kv_int8 as tool

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rows(rng, dtype):
    """(4, 5, 32) rows with the edge cases: a zero row, rows at +-max in
    every element, and a row of exact .5 ties (scale 1)."""
    rows = (rng.standard_normal((4, 5, 32)) * 2.0).astype(np.float32)
    rows[0, 0] = 0.0
    rows[0, 1] = 3.25
    rows[0, 2] = np.where(np.arange(32) % 2, -7.5, 7.5)
    rows[1, 0] = 0.0
    rows[1, 0, :11] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5,
                       63.5, -127.0]
    rows[2, 3, 5] = -40.0                   # a negative max
    if dtype == "bf16":
        return jnp.asarray(rows, jnp.bfloat16), _t(rows).bfloat16()
    return jnp.asarray(rows), _t(rows)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_kv_rows_bit_equal_to_jax(dtype):
    """Bit-equal int8 rows and f32 scales, zero rows at scale 0, ties
    rounded half to even."""
    jrows, trows = _rows(np.random.default_rng(0), dtype)
    jq, js = jkv.quantize_kv_rows(jrows)
    tq, ts = tkv.quantize_kv_rows(trows)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))
    assert (tq[0, 0] == 0).all() and float(ts[0, 0]) == 0.0
    assert (tq[0, 1] == 127).all()
    assert tq[1, 0, :7].tolist() == [127, 0, 2, 2, 0, -2, -2]


def _case(rng, B, Hq, Hkv, Dh, S, pos):
    q = rng.standard_normal((B, Hq, Dh)).astype(np.float32)
    kf = (rng.standard_normal((B, Hkv, S, Dh)) * 0.5).astype(np.float32)
    vf = (rng.standard_normal((B, Hkv, S, Dh)) * 0.5).astype(np.float32)
    kq, ks = (np.asarray(a) for a in jkv.quantize_kv_rows(jnp.asarray(kf)))
    vq, vs = (np.asarray(a) for a in jkv.quantize_kv_rows(jnp.asarray(vf)))
    return q, kq, ks, vq, vs, np.asarray(pos, np.int32)


@pytest.mark.parametrize("qdtype", ["f32", "bf16"])
def test_kv_int8_plain_matches_pallas(qdtype):
    """K6's plain version against decode_attention_kv_int8 (interpret) on
    the same int8 cache, pos 0 and S-1 included. f32 q: rtol = atol =
    2e-5 (tests/test_kv_int8.py's bound; the same f32 math in another
    summation order). bf16 q: the outputs, rounded to bf16, within one
    bf16 ulp of each other."""
    q, kq, ks, vq, vs, pos = _case(np.random.default_rng(1), 4, 8, 4, 16,
                                   24, [0, 23, 11, 5])
    jq = jnp.asarray(q, jnp.bfloat16) if qdtype == "bf16" else jnp.asarray(q)
    tq = _t(q).bfloat16() if qdtype == "bf16" else _t(q)
    want = jkv.decode_attention_kv_int8(jq, jnp.asarray(kq), jnp.asarray(ks),
                                        jnp.asarray(vq), jnp.asarray(vs),
                                        jnp.asarray(pos), interpret=True)
    got = tkv.decode_attention_kv_int8(tq, _t(kq), _t(ks), _t(vq), _t(vs),
                                       _t(pos))
    assert got.shape == (4, 8 * 16) and got.dtype == tq.dtype
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    if qdtype == "f32":
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert (np.abs(got - want) <= ulp).all()


def test_kv_int8_plain_ignores_rows_past_pos():
    """Rows past each row's pos must not leak: setting them to +-99 before
    quantizing changes no bit of the output."""
    rng = np.random.default_rng(2)
    B, Hq, Hkv, Dh, S = 3, 4, 2, 16, 20
    q = _t(rng.standard_normal((B, Hq, Dh)).astype(np.float32))
    kf = _t(rng.standard_normal((B, Hkv, S, Dh)).astype(np.float32))
    vf = _t(rng.standard_normal((B, Hkv, S, Dh)).astype(np.float32))
    pos = torch.tensor([4, 0, S - 2])

    def run(kf, vf):
        kq, ks = tkv.quantize_kv_rows(kf)
        vq, vs = tkv.quantize_kv_rows(vf)
        return tkv.decode_attention_kv_int8(q, kq, ks, vq, vs, pos)

    a = run(kf, vf)
    kp, vp = kf.clone(), vf.clone()
    for b, p in enumerate(pos.tolist()):
        kp[b, :, p + 1:] = 99.0
        vp[b, :, p + 1:] = -99.0
    torch.testing.assert_close(run(kp, vp), a, rtol=0, atol=0)


def test_kv_int8_wrapper_refuses_other_devices():
    meta = dict(device="meta")
    i8 = dict(dtype=torch.int8, **meta)
    with pytest.raises(ValueError):
        tkv.decode_attention_kv_int8(
            torch.empty((1, 4, 16), **meta), torch.empty((1, 2, 8, 16), **i8),
            torch.empty((1, 2, 8), **meta), torch.empty((1, 2, 8, 16), **i8),
            torch.empty((1, 2, 8), **meta),
            torch.zeros((1,), dtype=torch.int32, **meta))


# ---------------------------------------------------------------------------
# the tool's decode step
# ---------------------------------------------------------------------------

def _layers(rng, geo, scale=0.05):
    """A float32 talker layer stack (JAX init shapes) drawn from numpy."""
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


def _jax_step_kv8(layers, x, pos, cache, geo):
    """The JAX tool's decode_step_kv8 (tools/dev/bench_kv_int8.py, a
    closure there), rebuilt from the JAX package's own functions with K6
    in interpret mode; one layer at a time instead of a scan."""
    kq, ks, vq, vs = cache
    B = x.shape[0]
    cos, sin = jtfm.rope_cos_sin(pos[:, None], geo.head_dim, geo.rope_theta)
    b_idx = jnp.arange(B)[:, None]
    h_idx = jnp.arange(geo.num_kv_heads)[None, :]
    h = x
    for li in range(geo.num_layers):
        layer = {k: v[li] for k, v in layers.items()}
        hn = jtfm.rms_norm(h, layer["input_ln"], geo.rms_norm_eps)
        q, k, v = jtfm._qkv(layer, hn[:, None, :], geo, cos, sin)
        nk, nks = jkv.quantize_kv_rows(k[:, 0])
        nv, nvs = jkv.quantize_kv_rows(v[:, 0])
        kq = kq.at[li, b_idx, h_idx, pos[:, None]].set(nk)
        ks = ks.at[li, b_idx, h_idx, pos[:, None]].set(nks)
        vq = vq.at[li, b_idx, h_idx, pos[:, None]].set(nv)
        vs = vs.at[li, b_idx, h_idx, pos[:, None]].set(nvs)
        attn1 = jkv.decode_attention_kv_int8(q[:, 0], kq[li], ks[li], vq[li],
                                             vs[li], pos, interpret=True)
        h = h + jquant.matmul(attn1, layer["o_proj"]).astype(h.dtype)
        hn = jtfm.rms_norm(h, layer["post_ln"], geo.rms_norm_eps)
        h = h + jtfm.swiglu_mlp(hn, layer.get("gate_proj"),
                                layer.get("up_proj"), layer["down_proj"],
                                gateup_w=layer.get("gateup_proj"))
    return h, (kq, ks, vq, vs)


def test_decode_step_kv8_matches_jax_reconstruction():
    """Six steps of the tool's int8-KV step at the tiny talker geometry (2
    layers), f32, from the same quantized 8-position history and the same
    inputs: every step's hidden within 1e-4 x max|ref| of JAX's; the int8
    caches agree to one quantization step (an f32 rounding of k or v may
    cross a .5 tie) and the scales to rtol 1e-5."""
    jcfg = C.tiny_tts_config().talker
    jgeo = jtfm.geometry_of(jcfg)
    geo = ttfm.geometry_of(pconfig.tiny_tts_config().talker)
    assert dataclasses.asdict(geo) == dataclasses.asdict(jgeo)
    rng = np.random.default_rng(3)
    layers = _layers(rng, jgeo)
    B, S, T = 2, 16, 6
    L, Hkv, Dh, H = (jgeo.num_layers, jgeo.num_kv_heads, jgeo.head_dim,
                     jgeo.hidden_size)
    hist = (rng.standard_normal((L, 2, B, Hkv, S, Dh)) * 0.3
            ).astype(np.float32)
    hist[..., 8:, :] = 0.0
    cache = []
    for i in (0, 1):
        cq, cs = jkv.quantize_kv_rows(jnp.asarray(hist[:, i]))
        cache += [np.asarray(cq), np.asarray(cs)]
    xs = (rng.standard_normal((T, B, H)) * 0.3).astype(np.float32)
    pos0 = np.array([8, 5], np.int32)

    jl = {k: jnp.asarray(v) for k, v in layers.items()}
    tl = {k: _t(v) for k, v in layers.items()}
    jc = tuple(jnp.asarray(a) for a in cache)
    tc = tuple(_t(a) for a in cache)
    for step in range(T):
        pos = pos0 + step
        want, jc = _jax_step_kv8(jl, jnp.asarray(xs[step]), jnp.asarray(pos),
                                 jc, jgeo)
        got, tc = tool.decode_step_kv8(tl, _t(xs[step]), _t(pos), tc, geo)
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max()
        assert err <= 1e-4 * np.abs(want).max(), (step, err)
    for i in (0, 2):
        d = np.abs(tc[i].numpy().astype(np.int32)
                   - np.asarray(jc[i]).astype(np.int32))
        assert d.max() <= 1
        np.testing.assert_allclose(tc[i + 1].numpy(), np.asarray(jc[i + 1]),
                                   rtol=1e-5, atol=0)


def test_bench_kv_int8_tool_runs_tiny():
    """The tool's probe end to end at the tiny geometry on the CPU: both
    loops run, the int8 trajectory stays within cosine 0.99 of the bf16
    one (random weights at the JAX init scales), and times are reported."""
    res = tool.run(pconfig.tiny_tts_config(), batches=(2,), rep=3, trials=1,
                   device="cpu")
    row = res[2]
    assert row["cos_min"] >= 0.99 and row["cos_last"] >= row["cos_min"]
    assert row["bf16_ms"] > 0 and row["int8kv_ms"] > 0
