"""The PyTorch port's kernels (qwen3_tts_tpu_torch/ops/kernels) against
their JAX twins, on the same numpy-seeded inputs.

On the CPU each port kernel runs its plain PyTorch version; the JAX side
runs the Pallas kernel in interpret mode, as tests/test_talker_kernel.py
and tests/test_cp_kernel.py do. tests/test_torch_cuda.py holds the CUDA
kernels to those plain versions on the card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qwen3_tts_tpu.models import transformer as jtfm
from qwen3_tts_tpu.ops import quant as jquant
from qwen3_tts_tpu.ops.pallas import cp_decode as jcp
from qwen3_tts_tpu.ops.pallas.qmatmul import qmatmul_pallas
from qwen3_tts_tpu.ops.pallas.talker_step import talker_decode_step_fused
from qwen3_tts_tpu_torch.io.weights import from_jax_numpy
from qwen3_tts_tpu_torch.ops.kernels import cp_decode as tcp
from qwen3_tts_tpu_torch.ops.kernels import qmatmul as tqm
from qwen3_tts_tpu_torch.ops.kernels import talker_step as tts

torch.set_num_threads(1)

# talker-step geometry of tests/test_talker_kernel.py
TGEO = jtfm.TransformerGeometry(
    num_layers=2, hidden_size=256, intermediate_size=256, num_heads=2,
    num_kv_heads=1, head_dim=128, rms_norm_eps=1e-6, rope_theta=1e6)
# a small code predictor: H=64, Dh=16, 2 layers, full 2048-code groups
CGEO = jtfm.TransformerGeometry(
    num_layers=2, hidden_size=64, intermediate_size=128, num_heads=4,
    num_kv_heads=2, head_dim=16, rms_norm_eps=1e-6, rope_theta=1e6)
CP_GROUPS, CP_VOCAB, CP_S = 15, 2048, 16


def _np(tree):
    """JAX params -> numpy, each QTensor as (q, scale)."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items() if k != "layers_list"}
    if isinstance(tree, jquant.QTensor):
        return (np.asarray(tree.q), np.asarray(tree.scale))
    return np.asarray(tree)


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
    return from_jax_numpy({"c": _np(tree)})["c"]


def _rope_tables(S, dh):
    cos, sin = jtfm.rope_cos_sin(jnp.arange(S, dtype=jnp.int32), dh, 1e6)
    return (cos, sin), (torch.from_numpy(np.array(cos)),
                        torch.from_numpy(np.array(sin)))


# ---------------------------------------------------------------------------
# K1 qmatmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M", [1, 5, 19, 41, 73])
def test_qmatmul_plain_matches_pallas(M):
    rng = np.random.default_rng(M)
    K, N = 96, 512
    x = rng.standard_normal((M, K)).astype(np.float32)
    q = rng.integers(-127, 128, (K, N)).astype(np.int8)
    s = (rng.random(N) * 0.01 + 1e-3).astype(np.float32)
    want = np.asarray(qmatmul_pallas(jnp.asarray(x), jnp.asarray(q),
                                     jnp.asarray(s), interpret=True))
    got = tqm.qmatmul(torch.from_numpy(x), torch.from_numpy(q),
                      torch.from_numpy(s)).numpy()
    # x is rounded to bf16 and int8 -> bf16 is exact: only the f32
    # summation order differs
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# ---------------------------------------------------------------------------
# K3 talker_step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def talker_case():
    rng = np.random.default_rng(0)
    B, S = 3, 32
    fused = jquant.quantize_layer_stack(
        jax.tree.map(jnp.asarray, _stack(rng, TGEO)), fuse=True)
    x = (rng.standard_normal((B, TGEO.hidden_size)) * 0.3).astype(np.float32)
    kv = (rng.standard_normal((TGEO.num_layers, 2, B, S, TGEO.num_kv_heads,
                               TGEO.head_dim)) * 0.2).astype(np.float32)
    pos = rng.integers(1, S - 1, (B,)).astype(np.int32)
    (jcos, jsin), (tcos, tsin) = _rope_tables(S, TGEO.head_dim)
    want_h, want_kv = talker_decode_step_fused(
        fused, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(kv), jcos, jsin,
        eps=TGEO.rms_norm_eps, interpret=True)
    kv_t = torch.from_numpy(kv.copy())
    got_h, got_kv = tts.talker_decode_step_fused(
        _port(fused), torch.from_numpy(x), torch.from_numpy(pos), kv_t,
        tcos, tsin, eps=TGEO.rms_norm_eps)
    return dict(pos=pos, kv=kv, want_h=np.asarray(want_h),
                want_kv=np.asarray(want_kv), got_h=got_h.numpy(),
                got_kv=got_kv.numpy())


def test_talker_step_hidden_matches_pallas(talker_case):
    # same op order as the TPU kernel: only f32 summation order, and with
    # it a one-ulp bf16 rounding flip, may differ
    np.testing.assert_allclose(talker_case["got_h"], talker_case["want_h"],
                               rtol=1e-2, atol=5e-3)


def test_talker_step_fresh_rows_match_pallas(talker_case):
    c = talker_case
    b_idx = np.arange(len(c["pos"]))
    np.testing.assert_allclose(c["got_kv"][:, :, b_idx, c["pos"]],
                               c["want_kv"][:, :, b_idx, c["pos"]],
                               rtol=1e-2, atol=5e-3)
    mask = np.ones(c["kv"].shape[2:4], bool)
    mask[b_idx, c["pos"]] = False
    np.testing.assert_array_equal(c["got_kv"][:, :, mask],
                                  c["kv"][:, :, mask])


# ---------------------------------------------------------------------------
# K2 cp_decode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cp_case():
    rng = np.random.default_rng(1)
    B, H = 3, CGEO.hidden_size
    w = lambda *s: (rng.standard_normal(s) * 0.02).astype(np.float32)
    dense = {"layers": _stack(rng, CGEO),
             "final_norm": np.ones((H,), np.float32),
             "mtp_proj_w": w(H, H), "mtp_proj_b": w(H),
             "codec_embs": w(CP_GROUPS, CP_VOCAB, H),
             "lm_heads": (rng.standard_normal((CP_GROUPS, H, CP_VOCAB))
                          * 0.2).astype(np.float32)}
    jparams = jquant.quantize_code_predictor(jax.tree.map(jnp.asarray, dense))
    kv = np.zeros((CGEO.num_layers, 2, B, CP_S, CGEO.num_kv_heads,
                   CGEO.head_dim), np.float32)
    kv[:, :, :, :2] = rng.standard_normal(kv[:, :, :, :2].shape) * 0.5
    tok0 = rng.integers(0, CP_VOCAB, (B,)).astype(np.int32)
    return dict(jparams=jparams, tparams=_port(jparams), kv=kv, tok0=tok0,
                tables=_rope_tables(CP_S, CGEO.head_dim), B=B)


def _run_cp(c, seeds, temperature, greedy):
    kw = dict(eps=CGEO.rms_norm_eps, top_k=50, temperature=temperature,
              greedy=greedy)
    (jcos, jsin), (tcos, tsin) = c["tables"]
    want = np.asarray(jcp.cp_decode_steps(
        c["jparams"], jnp.asarray(c["tok0"]), jnp.asarray(c["kv"]), jcos,
        jsin, jnp.asarray(seeds), interpret=True, **kw))
    got = tcp.cp_decode_steps(
        c["tparams"], torch.from_numpy(c["tok0"]), torch.from_numpy(c["kv"]),
        tcos, tsin, torch.from_numpy(seeds), **kw).numpy()
    return want, got


def test_cp_decode_greedy_matches_pallas(cp_case):
    seeds = np.arange(cp_case["B"], dtype=np.int32)
    want, got = _run_cp(cp_case, seeds, 0.0, True)
    np.testing.assert_array_equal(got, want)


def test_cp_decode_sampled_agrees_with_pallas(cp_case):
    """8 fixed seeds x 14 steps: the integer part of the sampler is
    bit-equal, so only log ulps near a Gumbel tie may flip a draw."""
    agree = total = 0
    for trial in range(8 // cp_case["B"] + 1):
        seeds = (np.arange(cp_case["B"]) * 7919 + trial * 104729 + 11
                 ).astype(np.int32)
        want, got = _run_cp(cp_case, seeds, 0.1, False)
        agree += int((want == got).sum())
        total += want.size
    assert total >= 8 * 14
    assert agree >= 0.99 * total, f"{total - agree} of {total} draws differ"


@pytest.mark.parametrize("temperature,greedy", [(0.1, False), (0.8, False),
                                                (0.0, True)])
def test_sample_tokens_bit_equal(temperature, greedy):
    """Random logits with ties and negative values: the port's sampler
    draws exactly the JAX kernel's tokens."""
    rng = np.random.default_rng(7)
    lg = (rng.standard_normal((24, 2048)) * 0.5).astype(np.float32)
    lg[0, :300] = 0.75                       # a tie across the top-k edge
    lg[1] = -np.abs(lg[1])                   # all negative
    lg[2, 10:80] = 0.0
    lg[2, 80:90] = -0.0                      # signed zeros
    lg[3] = 1.0                              # all equal
    seeds = rng.integers(-2 ** 31, 2 ** 31 - 1, (24, 1)).astype(np.int32)
    for step in (0, 5, 13):
        want = np.asarray(jcp.sample_tokens(
            jnp.asarray(lg), jnp.asarray(seeds), step, top_k=50,
            temperature=temperature, greedy=greedy))
        got = tcp.sample_tokens(torch.from_numpy(lg), torch.from_numpy(seeds),
                                step, top_k=50, temperature=temperature,
                                greedy=greedy).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [1, 50, 300])
def test_topk_keep_mask_bit_equal(k):
    rng = np.random.default_rng(k)
    lg = (rng.standard_normal((8, 2048)) * 2).astype(np.float32)
    lg[0, :400] = 0.5
    lg[1] = -np.abs(lg[1])
    want = np.asarray(jcp.topk_keep_mask(jnp.asarray(lg), k))
    got = tcp.topk_keep_mask(torch.from_numpy(lg), k).numpy()
    np.testing.assert_array_equal(got, want)


def _oracle_topk_temp_probs(logits, top_k, temperature):
    order = np.argsort(logits)[::-1][:top_k]
    z = logits[order] / temperature
    z -= z.max()
    p = np.exp(z) / np.exp(z).sum()
    probs = np.zeros(len(logits))
    probs[order] = p
    return probs


@pytest.mark.parametrize("temperature,spread", [(0.8, 1.0), (0.1, 0.08)])
def test_port_sampler_distribution_chi2(temperature, spread):
    """chi2 of 20k draws of the port's sampler against the top-k /
    temperature categorical (as tests/test_cp_kernel.py does for JAX)."""
    from scipy.stats import chi2

    V, N = 2048, 20000
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal(V) * spread).astype(np.float32)
    probs = _oracle_topk_temp_probs(logits, 50, temperature)
    draws = tcp.sample_tokens(
        torch.from_numpy(logits).expand(N, V),
        torch.arange(N, dtype=torch.int32)[:, None], 3, top_k=50,
        temperature=temperature, greedy=False)[:, 0].numpy()
    assert probs[draws].min() > 0, "draw outside the top-k support"
    expected = probs * N
    big = expected >= 5
    counts = np.bincount(draws, minlength=V).astype(np.float64)
    stat = float(np.sum((counts[big] - expected[big]) ** 2 / expected[big]))
    pool_e, pool_c = expected[~big].sum(), counts[~big].sum()
    stat += (pool_c - pool_e) ** 2 / max(pool_e, 1e-12)
    assert stat < chi2.ppf(1 - 1e-4, int(big.sum()))
