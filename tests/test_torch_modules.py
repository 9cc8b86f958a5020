"""The PyTorch port's modules (qwen3_tts_tpu_torch) against their JAX
twins, on the same numpy-seeded inputs and weights, on the CPU.

Weights are drawn once in JAX, turned into numpy arrays and handed to the
port through io/weights.from_jax_numpy, so both packages compute on the
same numbers. Each test states its tolerance and why.
"""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qwen3_tts_tpu import config as C
from qwen3_tts_tpu.io import weights as jweights
from qwen3_tts_tpu.models import code_predictor as jcp
from qwen3_tts_tpu.models import talker as jtk
from qwen3_tts_tpu.models import transformer as jtfm
from qwen3_tts_tpu.models import vocoder as jvoc
from qwen3_tts_tpu.ops import quant as jquant
from qwen3_tts_tpu.ops import sampling as jsmp
from qwen3_tts_tpu_torch import config as pconfig
from qwen3_tts_tpu_torch.io import weights as tweights
from qwen3_tts_tpu_torch.models import code_predictor as tcp
from qwen3_tts_tpu_torch.models import talker as ttk
from qwen3_tts_tpu_torch.models import transformer as ttfm
from qwen3_tts_tpu_torch.models import vocoder as tvoc
from qwen3_tts_tpu_torch.ops import quant as tquant
from qwen3_tts_tpu_torch.ops import sampling as tsmp

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TINY = C.tiny_tts_config(max_tokens=8)
GEO = jtfm.geometry_of(TINY.talker)
PTINY = pconfig.tiny_tts_config(max_tokens=8)    # the port's twin of TINY
PGEO = ttfm.geometry_of(PTINY.talker)


def _np(tree):
    """JAX params -> numpy, each QTensor as (q, scale)."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items() if k != "layers_list"}
    if isinstance(tree, jquant.QTensor):
        return (np.asarray(tree.q), np.asarray(tree.scale))
    return np.asarray(tree)


def _port(tree):
    return tweights.from_jax_numpy({"c": _np(tree)})["c"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.fixture(scope="module")
def params():
    """Tiny random params (f32), JAX and port."""
    jp = jweights.init_random_params(TINY, seed=3, dtype=jnp.float32)
    return jp, {k: _port(v) for k, v in jp.items()}


# ---------------------------------------------------------------------------
# package rules
# ---------------------------------------------------------------------------

def test_port_imports_without_jax():
    """Neither jax nor any module of the JAX package is loaded by the
    port (the GPU machine has no jax): every module of the package,
    found by walking it, is imported in one fresh process."""
    code = ("import importlib, pkgutil, sys\n"
            "import qwen3_tts_tpu_torch as pkg\n"
            "names = [m.name for m in pkgutil.walk_packages(\n"
            "    pkg.__path__, pkg.__name__ + '.')]\n"
            "for name in names:\n"
            "    importlib.import_module(name)\n"
            "for must in ('serve.daemon', 'serve.http', 'serve.compat',\n"
            "             'serve.voices', 'runtime.native', 'io.weights',\n"
            "             'models.encoder', 'tools.reference_client'):\n"
            "    assert pkg.__name__ + '.' + must in names, must\n"
            "assert 'jax' not in sys.modules\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'qwen3_tts_tpu'))\n"
            "assert not bad, bad\n"
            "print(len(names))\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 50


def test_port_sources_never_import_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|qwen3_tts_tpu)\b", re.M)
    for path in [ROOT / "chip_smoke.py",
                 *(ROOT / "qwen3_tts_tpu_torch").rglob("*.py")]:
        assert not pat.search(path.read_text()), path


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """chip_smoke.py never runs on the CPU instead: without a card it
    exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_port_config_matches_jax():
    """The port's copy of the config: every field it keeps has the JAX
    package's default, in the full and the tiny geometry, the derived
    vocoder sizes (total_upsample, output_crop) agree, and the constants
    (VOC_CHUNK_SIZE among them) are equal."""
    for jcfg, pcfg in ((C.TTSConfig(), pconfig.TTSConfig()),
                       (C.tiny_tts_config(8), pconfig.tiny_tts_config(8))):
        assert pcfg.max_tokens == jcfg.max_tokens
        for part in ("talker", "code_predictor", "vocoder", "sampling"):
            jp, pp = getattr(jcfg, part), getattr(pcfg, part)
            for f in dataclasses.fields(pp):
                assert getattr(pp, f.name) == getattr(jp, f.name), \
                    (part, f.name)
        assert pcfg.vocoder.total_upsample == jcfg.vocoder.total_upsample
        assert pcfg.vocoder.output_crop == jcfg.vocoder.output_crop
    for name in dir(pconfig):
        if name.isupper():
            assert getattr(pconfig, name) == getattr(C, name), name


# ---------------------------------------------------------------------------
# ops/quant
# ---------------------------------------------------------------------------

def test_quantize_int8_bit_equal():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((3, 64, 96)) * 0.02).astype(np.float32)
    w[1, :, 5] = 0.0                                 # an all-zero column
    jq = jquant.quantize_int8(jnp.asarray(w))
    tq = tquant.quantize_int8(_t(w))
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    np.testing.assert_allclose(tquant.dequantize(tq, torch.float32).numpy(),
                               np.asarray(jquant.dequantize(jq, jnp.float32)),
                               rtol=0, atol=0)


@pytest.mark.parametrize("fuse", [False, True])
def test_quantize_layer_stack_matches_jax(fuse, params):
    jp, tp = params
    jl = jquant.quantize_layer_stack(jp["talker"]["layers"], fuse=fuse)
    tl = tquant.quantize_layer_stack(tp["talker"]["layers"], fuse=fuse)
    assert sorted(jl) == sorted(tl)
    for name, jv in jl.items():
        if isinstance(jv, jquant.QTensor):
            np.testing.assert_array_equal(tl[name].q.numpy(),
                                          np.asarray(jv.q))
            np.testing.assert_array_equal(tl[name].scale.numpy(),
                                          np.asarray(jv.scale))


def test_quant_matmul_leading_dims_matches_jax():
    """A QTensor product over (2, 3, K) rows: flattened to K1's plain
    version. x rounds to bf16 and int8 -> bf16 is exact, so only the f32
    summation order differs: 1e-5 of the largest output."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 256)) * 0.02).astype(np.float32)
    jq = jquant.quantize_int8(jnp.asarray(w))
    want = np.asarray(jquant.matmul(jnp.asarray(x), jq, use_pallas=False))
    got = tquant.matmul(_t(x), _port({"w": jq})["w"])
    assert got.shape == (2, 3, 256) and got.dtype == torch.float32
    assert _rel_err(got.numpy(), want) <= 1e-5


# ---------------------------------------------------------------------------
# models/transformer (dense path)
# ---------------------------------------------------------------------------

# f32: the same ops in another summation order; bf16: the rounding points
# are the same, but a one-ulp flip of a bf16 activation is 2^-8 relative
TOL = {"f32": 1e-5, "bf16": 2e-2}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _stack_case(dtype_name, quantized=False):
    jdt, _ = DTYPES[dtype_name]
    layers = jtfm.init_stack_params(jax.random.PRNGKey(5), GEO, jdt)
    layers = {k: v + (0.05 * jax.random.normal(jax.random.PRNGKey(i), v.shape)
                      ).astype(jdt) if k.endswith(("ln", "norm")) else v
              for i, (k, v) in enumerate(layers.items())}
    if quantized:
        layers = jquant.quantize_layer_stack(layers, fuse=True)
    return layers, _port(layers)


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_forward_prefill_matches_jax(dtype_name):
    jdt, tdt = DTYPES[dtype_name]
    jl, tl = _stack_case(dtype_name)
    rng = np.random.default_rng(2)
    B, P, S = 2, 7, 12
    x = rng.standard_normal((B, P, GEO.hidden_size)).astype(np.float32)
    lengths = np.array([7, 4], np.int32)
    pos = np.broadcast_to(np.arange(P, dtype=np.int32), (B, P))
    jmask = jtfm.causal_mask(B, P, jnp.asarray(lengths))
    tmask = ttfm.causal_mask(B, P, _t(lengths))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    want_h, want_kv = jtfm.forward_prefill(
        jl, jnp.asarray(x, jdt), jnp.asarray(pos), jmask, GEO,
        jtfm.init_kv_cache(GEO, B, S, jdt))
    got_h, got_kv = ttfm.forward_prefill(
        tl, _t(x).to(tdt), _t(pos), tmask, PGEO,
        ttfm.init_kv_cache(PGEO, B, S, tdt))
    assert got_h.dtype == tdt and got_kv.shape == want_kv.shape
    assert _rel_err(got_h.float(), want_h) <= TOL[dtype_name]
    assert _rel_err(got_kv.float(), want_kv) <= TOL[dtype_name]


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_decode_step_matches_jax(dtype_name):
    jdt, tdt = DTYPES[dtype_name]
    jl, tl = _stack_case(dtype_name)
    rng = np.random.default_rng(3)
    B, S = 2, 12
    x = rng.standard_normal((B, GEO.hidden_size)).astype(np.float32)
    kv = (rng.standard_normal((GEO.num_layers, 2, B, S, GEO.num_kv_heads,
                               GEO.head_dim)) * 0.5).astype(np.float32)
    pos = np.array([3, 9], np.int32)
    want_h, want_kv = jtfm.decode_step(jl, jnp.asarray(x, jdt),
                                       jnp.asarray(pos),
                                       jnp.asarray(kv, jdt), GEO)
    got_h, got_kv = ttfm.decode_step(tl, _t(x).to(tdt), _t(pos).long(),
                                     _t(kv).to(tdt), PGEO)
    assert _rel_err(got_h.float(), want_h) <= TOL[dtype_name]
    assert _rel_err(got_kv.float(), want_kv) <= TOL[dtype_name]


def test_int8_prefill_matches_jax():
    """The fused-int8 stack (qkv_proj / gateup_proj through K1's plain
    version) against JAX's int8 XLA path, f32 activations. Every product
    rounds its input to bf16, so a summation-order difference can flip
    one bf16 rounding: bf16-grade tolerance."""
    jl, tl = _stack_case("f32", quantized=True)
    rng = np.random.default_rng(4)
    B, P = 1, 9
    x = rng.standard_normal((B, P, GEO.hidden_size)).astype(np.float32)
    lengths = np.array([P], np.int32)
    pos = np.arange(P, dtype=np.int32)[None]
    want_h, _ = jtfm.forward_prefill(
        jl, jnp.asarray(x), jnp.asarray(pos),
        jtfm.causal_mask(B, P, jnp.asarray(lengths)), GEO,
        jtfm.init_kv_cache(GEO, B, P))
    got_h, _ = ttfm.forward_prefill_unrolled(
        tquant.attach_layer_list({"layers": tl})["layers_list"], _t(x),
        _t(pos), ttfm.causal_mask(B, P, _t(lengths)), PGEO,
        ttfm.init_kv_cache(PGEO, B, P))
    assert _rel_err(got_h, want_h) <= 2e-2


def test_rope_tables_match_jax():
    pos = np.arange(0, 512, 7, dtype=np.int32)
    jc, js = jtfm.rope_cos_sin(jnp.asarray(pos), 128, 1e6)
    tc, ts = ttfm.rope_cos_sin(_t(pos), 128, 1e6)
    # f32 cos/sin of the same f32 angles; libm ulps may differ
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# ops/sampling: the deterministic transforms are bit-equal
# ---------------------------------------------------------------------------

def _logits(rng, B=4, V=3072):
    return (rng.standard_normal((B, V)) * 3).astype(np.float32)


def test_mask_code0_logits_bit_equal():
    lg = _logits(np.random.default_rng(0))
    np.testing.assert_array_equal(
        tsmp.mask_code0_logits(_t(lg)).numpy(),
        np.asarray(jsmp.mask_code0_logits(jnp.asarray(lg))))


def test_eos_boost_bit_equal():
    lg = _logits(np.random.default_rng(1), B=5)
    step = np.array([0, 10, 13, 25, 40], np.int32)
    n_text = np.array([5, 5, 5, 0, 6], np.int32)
    scfg = C.SamplingConfig()
    want_l, want_f = jax.vmap(
        lambda l, s, n: jsmp.eos_boost(l, s, n, scfg))(
            jnp.asarray(lg), jnp.asarray(step), jnp.asarray(n_text))
    got_l, got_f = tsmp.eos_boost(_t(lg), _t(step), _t(n_text),
                                  pconfig.SamplingConfig())
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))


def test_repetition_penalty_and_ring_push_bit_equal():
    rng = np.random.default_rng(2)
    lg = _logits(rng)
    ring = rng.integers(-1, 40, (4, 30)).astype(np.int32)
    lg[:, :40] = rng.standard_normal((4, 40)) * 3   # hits of both signs
    want = jax.vmap(lambda l, r: jsmp.repetition_penalty(l, r, 1.2))(
        jnp.asarray(lg), jnp.asarray(ring))
    got = tsmp.repetition_penalty(_t(lg), _t(ring), 1.2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    val = np.array([7, 2047, 0, 3], np.int32)
    np.testing.assert_array_equal(
        tsmp.ring_push(_t(ring), _t(val)).numpy(),
        np.asarray(jax.vmap(jsmp.ring_push)(jnp.asarray(ring),
                                            jnp.asarray(val))))


def test_greedy_samplers_match_jax():
    """Temperature 0: the port takes the first-index argmax; JAX's
    categorical over logits / 1e-6 puts all the mass on it too."""
    lg = _logits(np.random.default_rng(3), B=6, V=2048)
    seeds = tsmp.draw_seeds(tsmp.batch_keys(0, 6), torch.zeros(6),
                            tsmp.SITE_CODE0)
    key = jax.random.PRNGKey(0)
    want_p = [int(jsmp.topk_softmax_topp_sample(jnp.asarray(r), key, 50, 0.0,
                                                0.95)) for r in lg]
    want_t = [int(jsmp.topk_temperature_sample(jnp.asarray(r), key, 50, 0.0))
              for r in lg]
    got_p = tsmp.topk_softmax_topp_sample(_t(lg), seeds, 50, 0.0, 0.95)
    got_t = tsmp.topk_temperature_sample(_t(lg), seeds, 50, 0.0)
    assert got_p.tolist() == want_p == list(lg.argmax(-1))
    assert got_t.tolist() == want_t


def _chi2_ok(draws, probs, n):
    from scipy.stats import chi2
    expected = probs * n
    big = expected >= 5
    counts = np.bincount(draws, minlength=len(probs)).astype(np.float64)
    stat = float(np.sum((counts[big] - expected[big]) ** 2 / expected[big]))
    pool_e, pool_c = expected[~big].sum(), counts[~big].sum()
    stat += (pool_c - pool_e) ** 2 / max(pool_e, 1e-12)
    return stat < chi2.ppf(1 - 1e-4, int(big.sum()))


def test_topk_topp_sampler_distribution_chi2():
    """20k draws of the code_0 sampler, one per row key, against the
    top-k / temperature / nucleus categorical computed in numpy."""
    V, N, k, temp, top_p = 3072, 20000, 50, 0.8, 0.95
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal(V) * 1.0).astype(np.float32)
    order = np.argsort(-logits, kind="stable")[:k]
    p = np.exp((logits[order] - logits[order].max()) / temp)
    p /= p.sum()
    shifted = np.concatenate([[0.0], np.cumsum(p)[:-1]])
    p = np.where(shifted < top_p, p, 0.0)
    probs = np.zeros(V)
    probs[order] = p / p.sum()
    seeds = tsmp.draw_seeds(tsmp.batch_keys(1, N), torch.zeros(N),
                            tsmp.SITE_CODE0)
    draws = tsmp.topk_softmax_topp_sample(
        _t(logits).expand(N, V), seeds, k, temp, top_p).numpy()
    assert probs[draws].min() > 0, "draw outside the nucleus"
    assert _chi2_ok(draws, probs, N)


def test_sample_code0_forces_eos():
    scfg = pconfig.SamplingConfig()
    lg = _logits(np.random.default_rng(5), B=2)
    ring = np.full((2, 30), -1, np.int32)
    step = np.array([0, 31], np.int32)          # progress 31/15 > 2.0
    n_text = np.array([5, 5], np.int32)
    got = tsmp.sample_code0(_t(lg), _t(ring), _t(step), _t(n_text),
                            tsmp.draw_seeds(tsmp.batch_keys(0, 2), _t(step),
                                            tsmp.SITE_CODE0), scfg)
    assert got.dtype == torch.int32
    assert int(got[1]) == C.CODEC_EOS_ID
    assert 0 <= int(got[0]) < C.NUM_AUDIO_CODES or \
        int(got[0]) == C.CODEC_EOS_ID


# ---------------------------------------------------------------------------
# models/talker and models/code_predictor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_text", [0, 5, 8, 13])
def test_build_prefix_matches_jax(n_text, params):
    """f32 embedding sums: exact to 1e-6. n_text 13 > N_pad 8 exercises
    the clamp."""
    jp, tp = params
    ids = np.array([11, 22, 33, 44, 55, 66, 77, 88], np.int32)
    want, want_len = jtk.build_prefix(jp["talker"], jnp.asarray(ids),
                                      jnp.int32(n_text))
    got, got_len = ttk.build_prefix(tp["talker"], _t(ids), n_text)
    assert int(got_len) == int(want_len) == min(n_text, 8) + 9
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_talker_prefill_decode_and_logits_match_jax(params):
    jp, tp = params
    jcfg, tcfg = TINY.talker, PTINY.talker
    ids = np.array([5, 6, 7, 8, 0, 0, 0, 0], np.int32)
    jpre, jlen = jtk.build_prefix(jp["talker"], jnp.asarray(ids), 4)
    tpre, tlen = ttk.build_prefix(tp["talker"], _t(ids), 4)
    S = tcfg.max_seq_len
    jh, jkv = jtk.prefill(jp["talker"], jpre[None], jlen[None],
                          jtfm.init_kv_cache(GEO, 1, S), jcfg)
    th, tkv = ttk.prefill(tp["talker"], tpre[None], tlen[None],
                          ttfm.init_kv_cache(PGEO, 1, S), tcfg)
    assert _rel_err(th, jh) <= 1e-5
    assert _rel_err(tkv, jkv) <= 1e-5
    np.testing.assert_allclose(
        ttk.codec_logits(tp["talker"], th).numpy(),
        np.asarray(jtk.codec_logits(jp["talker"], jh)), rtol=1e-4, atol=1e-6)
    fb = np.random.default_rng(6).standard_normal((1, GEO.hidden_size))
    fb = fb.astype(np.float32)
    jh2, jkv2 = jtk.decode_step(jp["talker"], jnp.asarray(fb), jlen[None],
                                jkv, jcfg)
    th2, tkv2 = ttk.decode_step(tp["talker"], _t(fb), tlen[None].long(),
                                tkv, tcfg)
    assert _rel_err(th2, jh2) <= 1e-5
    assert _rel_err(tkv2, jkv2) <= 1e-5


def test_predict_codes_greedy_matches_jax(params):
    """Dense f32 code predictor, greedy: the 15 groups are equal."""
    jp, tp = params
    rng = np.random.default_rng(7)
    hidden = rng.standard_normal((2, GEO.hidden_size)).astype(np.float32)
    c0 = np.asarray(jp["talker"]["codec_embedding"])[[17, 900]]
    want = jcp.predict_codes(jp["code_predictor"], jnp.asarray(hidden),
                             jnp.asarray(c0), jax.random.PRNGKey(0),
                             TINY.code_predictor,
                             C.SamplingConfig(cp_temperature=0.0))
    got = tcp.predict_codes(tp["code_predictor"], _t(hidden), _t(c0),
                            tsmp.token_seeds(tsmp.batch_keys(0, 2),
                                             torch.zeros(2))[:, 1:],
                            PTINY.code_predictor,
                            pconfig.SamplingConfig(cp_temperature=0.0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# models/vocoder and io/weights
# ---------------------------------------------------------------------------

def test_vocoder_decode_matches_jax(params):
    """The tiny FP32 vocoder through from_jax_numpy, so the WIO and
    pre-flipped transposed-conv weights are converted inside the port:
    f32 convolutions in another summation order, atol 1e-4."""
    jp, tp = params
    codes = np.random.default_rng(8).integers(0, 2048, (2, 6, 16))
    codes = codes.astype(np.int32)
    want = np.asarray(jvoc.decode(jp["vocoder"], jnp.asarray(codes),
                                  TINY.vocoder))
    got = tvoc.decode(tp["vocoder"], _t(codes), PTINY.vocoder).numpy()
    assert got.shape == want.shape == (2, 6 * 1920)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_vocoder_helpers_match_jax():
    for w in (1, 64, 65, 300, 321, 700):
        assert tvoc.voc_bucket(w) == jvoc.voc_bucket(w)
    codes = np.arange(5 * 16, dtype=np.int32).reshape(5, 16)
    for W in (3, 5, 9):
        np.testing.assert_array_equal(
            tvoc.pad_codes(_t(codes), W).numpy(),
            np.asarray(jvoc.pad_codes(codes, W)))
    audio = np.array([-1.5, -1.0, -0.3, 0.0, 0.5, 1.0, 2.0], np.float32)
    np.testing.assert_array_equal(tvoc.to_int16(audio), jvoc.to_int16(audio))


def test_init_random_params_matches_jax_layout():
    """Same tree, shapes and dtypes as the JAX init (the vocoder f32
    whatever dtype), so chip_smoke's random engine has the JAX layout."""
    jp = jax.eval_shape(lambda: jweights.init_random_params(
        TINY, seed=0, dtype=jnp.bfloat16))
    tp = tweights.init_random_params(PTINY, seed=0, dtype=torch.bfloat16)

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", tuple(v.shape), str(v.dtype)

    want = sorted((k, s, d.replace("torch.", "")) for k, s, d in flat(jp))
    got = sorted((k, s, d.replace("torch.", "")) for k, s, d in flat(tp))
    assert got == want
    w = tp["talker"]["layers"]["q_proj"].float()
    assert abs(float(w.std()) - 0.02) < 2e-3
