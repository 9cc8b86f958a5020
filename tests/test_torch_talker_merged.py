"""K7, the talker step over merged weight streams
(qwen3_tts_tpu_torch/ops/kernels/talker_merged.py), and the port of its
tool (qwen3_tts_tpu_torch/tools/microbench_talker_merged.py), on the CPU:
the merged layout against a numpy rebuild of the JAX tool's ``premerge``,
K7's plain version against K3's (the same math, so bit for bit), against
the JAX package's K3 and against the JAX tool's merged kernel, both in
interpret mode, and the tool's three variants through the decode loop.
Inputs are drawn with numpy from fixed seeds.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from qwen3_tts_tpu.models import transformer as jtfm
from qwen3_tts_tpu.ops import quant as jquant
from qwen3_tts_tpu.ops.pallas import common as jcommon
from qwen3_tts_tpu.ops.pallas.talker_step import BP, talker_decode_step_fused
from qwen3_tts_tpu_torch import config as pconfig
from qwen3_tts_tpu_torch.io.weights import from_jax_numpy
from qwen3_tts_tpu_torch.ops.kernels import talker_merged as tm
from qwen3_tts_tpu_torch.ops.kernels import talker_step as tts
from qwen3_tts_tpu_torch.tools import microbench_talker_merged as tool

torch.set_num_threads(1)

# talker-step geometry of tests/test_talker_kernel.py
TGEO = jtfm.TransformerGeometry(
    num_layers=2, hidden_size=256, intermediate_size=256, num_heads=2,
    num_kv_heads=1, head_dim=128, rms_norm_eps=1e-6, rope_theta=1e6)
VARIANTS = {"merged": tm.talker_decode_step_merged,
            "mergedvec": tm.talker_decode_step_mergedvec}


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


def _np(tree):
    return {k: ((np.asarray(v.q), np.asarray(v.scale))
                if isinstance(v, jquant.QTensor) else np.asarray(v))
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def case():
    """One fused-int8 stack, JAX's and the port's, and one step's inputs;
    JAX's K3 (interpret) on them."""
    rng = np.random.default_rng(0)
    B, S = 3, 32
    jl = jquant.quantize_layer_stack(
        jax.tree.map(jnp.asarray, _stack(rng, TGEO)), fuse=True)
    npl = _np(jl)
    layers = tm.with_merged(from_jax_numpy({"c": {"layers": npl}})["c"]
                            ["layers"])
    x = (rng.standard_normal((B, TGEO.hidden_size)) * 0.3).astype(np.float32)
    kv = (rng.standard_normal((TGEO.num_layers, 2, B, S, TGEO.num_kv_heads,
                               TGEO.head_dim)) * 0.2).astype(np.float32)
    pos = np.array([1, 30, 17], np.int32)
    cos, sin = jtfm.rope_cos_sin(jnp.arange(S, dtype=jnp.int32),
                                 TGEO.head_dim, 1e6)
    want_h, want_kv = talker_decode_step_fused(
        jl, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(kv), cos, sin,
        eps=TGEO.rms_norm_eps, interpret=True)
    return dict(jl=jl, npl=npl, layers=layers, x=x, kv=kv, pos=pos,
                cos=torch.from_numpy(np.array(cos)),
                sin=torch.from_numpy(np.array(sin)),
                want_h=np.asarray(want_h), want_kv=np.asarray(want_kv))


def test_premerge_layout_matches_the_tool(case):
    """wA, sA, wB, sB and vec equal a numpy rebuild of the JAX tool's
    premerge (tools/dev/microbench_talker_merged.py), exactly."""
    n = case["npl"]
    L = n["qkv_proj"][0].shape[0]
    want = {"wA": np.concatenate([n["qkv_proj"][0], n["gateup_proj"][0]], 2),
            "sA": np.concatenate([n["qkv_proj"][1], n["gateup_proj"][1]], -1),
            "wB": np.concatenate([n["o_proj"][0], n["down_proj"][0]], 1),
            "sB": np.concatenate([n["o_proj"][1], n["down_proj"][1]], -1)}
    want["vec"] = np.concatenate(
        [a.astype(np.float32).reshape(L, 1, -1)
         for a in (want["sA"], want["sB"], n["input_ln"], n["post_ln"],
                   n["q_norm"], n["k_norm"])], -1)
    got = tm.premerge(case["layers"])
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == (torch.int8 if k[0] == "w" else torch.float32)
        np.testing.assert_array_equal(got[k].numpy(), v)
        np.testing.assert_array_equal(case["layers"][f"m_{k}"].numpy(), v)


def _run(fn, c):
    kv = torch.from_numpy(c["kv"].copy())
    h, kv = fn(c["layers"], torch.from_numpy(c["x"]),
               torch.from_numpy(c["pos"]), kv, c["cos"], c["sin"],
               eps=TGEO.rms_norm_eps)
    return h.numpy(), kv.numpy()


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_merged_plain_bit_equal_to_k3_plain(case, variant):
    """The same math over views of the merged blocks: h and the cache with
    the fresh rows equal K3's plain version bit for bit."""
    h, kv = _run(VARIANTS[variant], case)
    h3, kv3 = _run(tts.talker_decode_step_fused, case)
    np.testing.assert_array_equal(h, h3)
    np.testing.assert_array_equal(kv, kv3)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_merged_plain_matches_jax_k3(case, variant):
    """K7's plain version against JAX's K3 in interpret mode, held to
    tests/test_torch_kernels.py's tolerance for K3 (rtol 1e-2 / atol 5e-3:
    only f32 summation order, and with it a one-ulp bf16 rounding flip,
    may differ); rows other than pos untouched."""
    h, kv = _run(VARIANTS[variant], case)
    np.testing.assert_allclose(h, case["want_h"], rtol=1e-2, atol=5e-3)
    pos = case["pos"]
    b_idx = np.arange(len(pos))
    np.testing.assert_allclose(kv[:, :, b_idx, pos],
                               case["want_kv"][:, :, b_idx, pos],
                               rtol=1e-2, atol=5e-3)
    mask = np.ones(kv.shape[2:4], bool)
    mask[b_idx, pos] = False
    np.testing.assert_array_equal(kv[:, :, mask], case["kv"][:, :, mask])


def _jax_merged_step(layers, x, pos, kv, rope_cos, rope_sin, *, eps,
                     vec_merged):
    """The JAX tool's ``merged_step`` (a closure in its main(), so rebuilt
    here line for line around its kernel body ``_build_merged_kernel``),
    run in interpret mode. layers: JAX's fused-int8 stack with the merged
    blocks under m_wA, m_sA, m_wB, m_sB and m_vec."""
    from tools.dev.microbench_talker_merged import _build_merged_kernel
    L, H, QKVD = layers["qkv_proj"].q.shape
    Dh = layers["q_norm"].shape[-1]
    QD = layers["o_proj"].q.shape[1]
    nH, nKV = QD // Dh, (QKVD - QD) // (2 * Dh)
    I = layers["down_proj"].q.shape[1]
    B, S = kv.shape[2], kv.shape[3]
    x_pad = jnp.zeros((BP, H), jnp.bfloat16).at[:B].set(
        x.astype(jnp.bfloat16))
    kern = _build_merged_kernel(jax, jnp, pl, pltpu, jcommon, BP,
                                vec_merged=vec_merged)(
        B, L, nH, nKV, S, Dh, H, I, eps)

    def inv(a):
        return pl.BlockSpec(a.shape, lambda i, ps, _n=a.ndim: (0,) * _n,
                            memory_space=pltpu.VMEM)

    def per_layer(a):
        return pl.BlockSpec(
            (1,) + a.shape[1:],
            lambda i, ps, _n=a.ndim: (i,) + (0,) * (_n - 1),
            memory_space=pltpu.VMEM)

    def v3(a):
        return a.astype(jnp.float32).reshape(L, 1, -1)

    kv_bf = kv.astype(jnp.bfloat16)
    head = [rope_cos.astype(jnp.float32), rope_sin.astype(jnp.float32),
            x_pad]
    if vec_merged:
        blocks = [layers["m_wA"], layers["m_wB"], layers["m_vec"]]
    else:
        blocks = [layers["m_wA"], v3(layers["m_sA"]), layers["m_wB"],
                  v3(layers["m_sB"])] + [v3(layers[n]) for n in tm.NORMS]
    in_specs = ([inv(a) for a in head] + [per_layer(a) for a in blocks]
                + [pl.BlockSpec((1,) + kv_bf.shape[1:],
                                lambda i, ps: (i, 0, 0, 0, 0, 0),
                                memory_space=pltpu.VMEM)])
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(L,), in_specs=in_specs,
        out_specs=[pl.BlockSpec((BP, H), lambda i, ps: (0, 0),
                                memory_space=pltpu.VMEM),
                   pl.BlockSpec((1, 2, B, nKV, Dh),
                                lambda i, ps: (i, 0, 0, 0, 0),
                                memory_space=pltpu.VMEM)],
        scratch_shapes=[pltpu.VMEM((BP, H), jnp.float32),
                        pltpu.VMEM((BP, Dh), jnp.float32),
                        pltpu.VMEM((BP, Dh), jnp.float32)])
    h_out, rows = pl.pallas_call(
        kern, grid_spec=grid_spec,
        out_shape=[jax.ShapeDtypeStruct((BP, H), jnp.bfloat16),
                   jax.ShapeDtypeStruct((L, 2, B, nKV, Dh), jnp.float32)],
        interpret=True,
    )(pos.astype(jnp.int32), *head, *blocks, kv_bf)
    new_kv = kv.at[:, :, jnp.arange(B), pos].set(rows.astype(kv.dtype))
    return h_out[:B].astype(x.dtype), new_kv


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_merged_plain_matches_jax_merged_kernel(case, variant):
    """K7's plain version against the JAX tool's own merged kernel in
    interpret mode, on the same merged blocks, held to K3's tolerance
    (rtol 1e-2 / atol 5e-3, as above)."""
    jl = {**case["jl"], **{k: jnp.asarray(v.numpy())
                           for k, v in case["layers"].items()
                           if k.startswith("m_")}}
    want_h, want_kv = _jax_merged_step(
        jl, jnp.asarray(case["x"]), jnp.asarray(case["pos"]),
        jnp.asarray(case["kv"]), jnp.asarray(case["cos"].numpy()),
        jnp.asarray(case["sin"].numpy()), eps=TGEO.rms_norm_eps,
        vec_merged=variant == "mergedvec")
    h, kv = _run(VARIANTS[variant], case)
    np.testing.assert_allclose(h, np.asarray(want_h), rtol=1e-2, atol=5e-3)
    np.testing.assert_allclose(kv, np.asarray(want_kv), rtol=1e-2,
                               atol=5e-3)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_merged_wrapper_refuses_other_devices(variant):
    meta = dict(device="meta")
    with pytest.raises(ValueError):
        VARIANTS[variant]({}, torch.empty((1, 64), **meta),
                          torch.zeros((1,), dtype=torch.int32, **meta),
                          torch.empty((1, 2, 1, 8, 1, 16), **meta), None,
                          None, eps=1e-6)


def test_tool_variants_give_equal_codes(monkeypatch):
    """The tool at the tiny geometry, 8 tokens, no timed trials: its three
    variants decode the same codes through engine/generate.run_steps
    (the tool raises otherwise), and each variant's step really ran: the
    talker step swapped into models/talker took K3's plain version in
    "full" and K7's in "merged" and "mergedvec", once per loop step."""
    calls = []
    k3, k7 = tts.talker_step_plain, tm.talker_merged_plain
    monkeypatch.setattr(tts, "talker_step_plain",
                        lambda *a: calls.append("full") or k3(*a))
    monkeypatch.setattr(
        tm, "talker_merged_plain",
        lambda *a: calls.append("mergedvec" if a[-1] else "merged")
        or k7(*a))
    res = tool.run(pconfig.tiny_tts_config(), n_tok=8, trials=0,
                   device="cpu")
    n = res["n_codes"]
    assert 1 <= n <= 8 and res["codes"].shape == (n, 16)
    assert ((res["codes"] >= 0) & (res["codes"] < 2048)).all()
    counts = {v: calls.count(v) for v in ("full", "merged", "mergedvec")}
    assert counts["full"] >= n and len(set(counts.values())) == 1, counts
    assert res["ms_per_tok"] == {}
