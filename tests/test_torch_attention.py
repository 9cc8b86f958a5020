"""The port's decode attention against the JAX package, on the CPU: the
plain versions of K5 (decode_attention) and K4 (paged_attention) against
the Pallas kernels in interpret mode, the dense decode step with
``attention_impl="pallas"``, the paged decode step, and the K3 batch gate
(an int8 talker past 8 rows decodes per layer, as JAX's
decode_step_unrolled does). Inputs are drawn with numpy from fixed seeds;
each test states its tolerance.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qwen3_tts_tpu import config as C
from qwen3_tts_tpu.models import transformer as jtfm
from qwen3_tts_tpu.ops import quant as jquant
from qwen3_tts_tpu.ops.pallas import decode_attention as jda
from qwen3_tts_tpu.ops.pallas import paged_attention as jpa
from qwen3_tts_tpu_torch import config as pconfig
from qwen3_tts_tpu_torch.io import weights as tweights
from qwen3_tts_tpu_torch.models import talker as ttk
from qwen3_tts_tpu_torch.models import transformer as ttfm
from qwen3_tts_tpu_torch.ops import quant as tquant
from qwen3_tts_tpu_torch.ops.kernels import decode_attention as tda
from qwen3_tts_tpu_torch.ops.kernels import paged_attention as tpa
from qwen3_tts_tpu_torch.ops.kernels import talker_step as tts_kernel

torch.set_num_threads(1)

# the paged tests' geometry (tests/test_paged_kv.py)
GEO = jtfm.TransformerGeometry(
    num_layers=2, hidden_size=64, intermediate_size=128, num_heads=8,
    num_kv_heads=4, head_dim=16, rms_norm_eps=1e-6, rope_theta=1e6)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items() if k != "layers_list"}
    if isinstance(tree, jquant.QTensor):
        return (np.asarray(tree.q), np.asarray(tree.scale))
    return np.asarray(tree)


def _port(tree):
    return tweights.from_jax_numpy({"c": _np(tree)})["c"]


def _pgeo(geo, **kw):
    return ttfm.TransformerGeometry(**{**dataclasses.asdict(geo), **kw})


def _t(a):
    return torch.from_numpy(np.array(a))


def _scrambled(rng, dense, psz, n_pages):
    """(pool (L, 2, P, psz, Hkv, Dh), table (B, S/psz)) holding the rows
    of ``dense`` (L, 2, B, S, Hkv, Dh) through a non-contiguous table of
    pages 1..P-1 (page 0 stays the reserved page)."""
    L, _, B, S, Hkv, Dh = dense.shape
    per = S // psz
    perm = rng.permutation(np.arange(1, n_pages))[:B * per]
    table = perm.reshape(B, per).astype(np.int32)
    pool = np.zeros((L, 2, n_pages, psz, Hkv, Dh), np.float32)
    for b in range(B):
        for j in range(per):
            pool[:, :, table[b, j]] = dense[:, :, b, j * psz:(j + 1) * psz]
    return pool, table


def test_decode_attention_plain_matches_pallas():
    """K5's plain version against decode_attention_pallas (interpret),
    f32, pos 0 and S-1 included: rtol 1e-5 / atol 1e-6 (the same f32 math
    in another summation order)."""
    rng = np.random.default_rng(0)
    B, Hq, Hkv, Dh, S = 4, 8, 4, 16, 24
    q = rng.standard_normal((B, Hq, Dh)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32)
    pos = np.array([0, S - 1, 11, 5], np.int32)
    want = jda.decode_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), jnp.asarray(pos),
                                       interpret=True)
    got = tda.decode_attention(_t(q), _t(k), _t(v), _t(pos))
    assert got.shape == (B, Hq * Dh) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_paged_attention_plain_matches_pallas():
    """K4's plain version against paged_decode_attention_pallas
    (interpret) over a scrambled table whose unallocated entries are the
    reserved page 0: rtol 2e-5 / atol 2e-6 (tests/test_paged_kv.py)."""
    rng = np.random.default_rng(3)
    B, Hq, Hkv, Dh, P, psz, MAXP = 3, 8, 4, 16, 16, 8, 4
    q = (rng.standard_normal((B, Hq, Dh)) * 0.5).astype(np.float32)
    pool = (rng.standard_normal((2, P, psz, Hkv, Dh)) * 0.5
            ).astype(np.float32)
    table = rng.permutation(np.arange(1, P))[:B * MAXP].reshape(B, MAXP)
    table = table.astype(np.int32)
    table[0, 1:] = 0                      # row 0 holds one page
    pos = np.array([5, 31, 17], np.int32)
    want = jpa.paged_decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(pool[0]), jnp.asarray(pool[1]),
        jnp.asarray(table), jnp.asarray(pos), interpret=True)
    got = tpa.paged_decode_attention(_t(q), _t(pool), _t(table), _t(pos))
    assert got.shape == (B, Hq * Dh) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-6)
    # bf16 queries come back in bf16 (the dispatcher's cast)
    got16 = tpa.paged_decode_attention(_t(q).bfloat16(), _t(pool),
                                       _t(table), _t(pos))
    assert got16.dtype == torch.bfloat16


def test_paged_attention_equals_dense_over_gathered_rows():
    """K4 and K5 (plain versions) on the same logical rows: the online
    softmax and the one-pass softmax agree to f32 rounding, 1e-5 x
    max|ref|."""
    rng = np.random.default_rng(5)
    B, Hq, Hkv, Dh, psz, MAXP = 2, 8, 4, 16, 8, 5
    dense = (rng.standard_normal((1, 2, B, psz * MAXP, Hkv, Dh)) * 0.5
             ).astype(np.float32)
    pool, table = _scrambled(rng, dense, psz, 16)
    q = rng.standard_normal((B, Hq, Dh)).astype(np.float32)
    pos = torch.tensor([3, 37])
    got = tpa.paged_decode_attention(_t(q), _t(pool[0]), _t(table), pos)
    kv = tpa.paged_gather_kv(_t(pool[0]), _t(table))
    np.testing.assert_array_equal(kv.numpy(), dense[0])
    ref = tda.decode_attention(_t(q), kv[0], kv[1], pos)
    err = float((got - ref).abs().max())
    assert err <= 1e-5 * float(ref.abs().max())


def test_decode_step_pallas_matches_jax(monkeypatch):
    """The dense decode step with attn_impl="pallas" (K5's plain version)
    against JAX's with decode_attention_pallas in interpret mode: rtol
    3e-4 on h, 1e-5 on the cache (tests/test_pallas_kernels.py)."""
    orig = jda.decode_attention_pallas
    monkeypatch.setattr(
        jda, "decode_attention_pallas",
        lambda q, k, v, p, interpret=False: orig(q, k, v, p, interpret=True))
    geo = dataclasses.replace(GEO, attn_impl="pallas")
    params = jtfm.init_stack_params(jax.random.PRNGKey(0), geo)
    rng = np.random.default_rng(1)
    B, S = 3, 32
    kv = (rng.standard_normal((2, 2, B, S, 4, 16)) * 0.2).astype(np.float32)
    x = (rng.standard_normal((B, 64)) * 0.3).astype(np.float32)
    pos = np.array([0, 9, S - 1], np.int32)
    want_h, want_kv = jtfm.decode_step(params, jnp.asarray(x),
                                       jnp.asarray(pos), jnp.asarray(kv), geo)
    tda.decode_attention.launches = 0
    got_h, got_kv = ttfm.decode_step(_port(params), _t(x), _t(pos).long(),
                                     _t(kv), _pgeo(geo))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=3e-4,
                               atol=3e-4)
    np.testing.assert_allclose(got_kv.numpy(), np.asarray(want_kv),
                               rtol=1e-5, atol=1e-5)
    assert tda.decode_attention.launches == 0   # the CPU runs no kernel


def test_paged_decode_step_matches_jax():
    """paged_decode_step (K4's plain version) against JAX's on the CPU
    (its XLA gather path), scrambled table: rtol 2e-5 / atol 2e-6 on h;
    the new rows land at (table[pos // psz], pos % psz), equal to JAX's to
    the f32 rounding of the projections (rtol 1e-5 / atol 1e-6)."""
    params = jtfm.init_stack_params(jax.random.PRNGKey(0), GEO)
    rng = np.random.default_rng(2)
    B, S, psz, P = 3, 32, 8, 64
    dense = (rng.standard_normal((2, 2, B, S, 4, 16)) * 0.2
             ).astype(np.float32)
    pool, table = _scrambled(rng, dense, psz, P)
    x = (rng.standard_normal((B, 64)) * 0.3).astype(np.float32)
    pos = np.array([5, 13, 26], np.int32)
    jpaged = jtfm.PagedKV(pool=jnp.asarray(pool), table=jnp.asarray(table),
                          capacity=jnp.full((B,), S, jnp.int32))
    want_h, want_paged = jtfm.paged_decode_step(
        params, jnp.asarray(x), jnp.asarray(pos), jpaged, GEO)
    tpaged = ttfm.PagedKV(pool=_t(pool), table=_t(table),
                          capacity=torch.full((B,), S, dtype=torch.int32))
    got_h, got_paged = ttfm.paged_decode_step(_port(params), _t(x),
                                              _t(pos).long(), tpaged,
                                              _pgeo(GEO))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=2e-5,
                               atol=2e-6)
    for b in range(B):
        p = int(pos[b])
        pid = int(table[b, p // psz])
        np.testing.assert_allclose(got_paged.pool[:, :, pid, p % psz].numpy(),
                                   np.asarray(want_paged.pool[:, :, pid,
                                                              p % psz]),
                                   rtol=1e-5, atol=1e-6)
        assert not np.allclose(pool[:, :, pid, p % psz],
                               got_paged.pool[:, :, pid, p % psz].numpy())
    assert ttfm.kv_capacity(tpaged) is tpaged.capacity


def test_paged_scatter_rows_lands_in_the_slot_pages():
    geo = _pgeo(GEO)
    paged = ttfm.init_paged_kv(geo, 2, 8, 4, 3)
    paged.table[1] = torch.tensor([6, 2, 0], dtype=torch.int32)
    rows = torch.arange(2 * 2 * 7 * 4 * 16, dtype=torch.float32).reshape(
        2, 2, 7, 4, 16)
    ttfm.paged_scatter_rows(paged, 1, rows)
    torch.testing.assert_close(paged.pool[:, :, 6], rows[:, :, :4])
    torch.testing.assert_close(paged.pool[:, :, 2, :3], rows[:, :, 4:])
    assert float(paged.pool[:, :, [0, 1, 3, 4, 5, 7]].abs().sum()) == 0


@pytest.mark.parametrize("B", [2, 9])
def test_int8_talker_decode_step_gate_matches_jax(B, monkeypatch):
    """An int8 (fused) tiny talker: at B <= 8 decode_step takes K3, past 8
    it decodes per layer over the same int8 stack (products on K1), as
    JAX's decode_step_unrolled does. Against decode_step_unrolled on the
    same weights: 2e-2 x max|ref| (every product rounds its input to
    bf16; test_int8_prefill_matches_jax)."""
    cfg = C.tiny_tts_config().talker
    geo = jtfm.geometry_of(cfg)
    layers = jtfm.init_stack_params(jax.random.PRNGKey(4), geo)
    layers = jquant.quantize_layer_stack(layers, fuse=True)
    jparams = jquant.attach_layer_list(
        {"layers": layers,
         "final_norm": jnp.ones((cfg.hidden_size,), jnp.float32)})
    rng = np.random.default_rng(B)
    S = 24
    kv = (rng.standard_normal((geo.num_layers, 2, B, S, geo.num_kv_heads,
                               geo.head_dim)) * 0.3).astype(np.float32)
    x = (rng.standard_normal((B, cfg.hidden_size)) * 0.3).astype(np.float32)
    pos = (np.arange(B) * 2 + 1).astype(np.int32)
    want_h, _ = jtfm.decode_step_unrolled(
        jparams["layers_list"], jnp.asarray(x), jnp.asarray(pos),
        jnp.asarray(kv), geo)
    want = jtfm.rms_norm(want_h, jparams["final_norm"], cfg.rms_norm_eps)
    tparams = tquant.attach_layer_list(_port(
        {k: v for k, v in jparams.items() if k != "layers_list"}))
    calls = []
    real = ttk.talker_decode_step_fused
    monkeypatch.setattr(ttk, "talker_decode_step_fused",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got, _ = ttk.decode_step(tparams, _t(x), _t(pos).long(), _t(kv),
                             pconfig.tiny_tts_config().talker)
    assert bool(calls) == (B <= tts_kernel.MAX_B)
    err = np.abs(got.numpy() - np.asarray(want)).max()
    assert err <= 2e-2 * np.abs(np.asarray(want)).max()
