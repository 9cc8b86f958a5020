"""The port's block-wise prefill (models/talker.prefill_chunked over
models/transformer.forward_window) against the JAX package's
talker.prefill_chunked, on the same numpy-seeded weights (through
io/weights.from_jax_numpy) and prefix, on the CPU at tiny geometry, f32
and int8 (the port's products on K1's plain version, JAX's on its XLA int8
path): the hidden and the real KV rows at the JAX test's tolerance
(tests/test_chunked_prefill.py, rtol = atol = 2e-4), and a decode step
after each (f32); the port's one-shot prefill against its chunked one,
with a decode step after each (f32 and int8); and the window grid that
overflows the cache.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qwen3_tts_tpu import config as C
from qwen3_tts_tpu.io import weights as jweights
from qwen3_tts_tpu.models import talker as jtk
from qwen3_tts_tpu.models import transformer as jtfm
from qwen3_tts_tpu.ops import quant as jquant
from qwen3_tts_tpu_torch import config as pconfig
from qwen3_tts_tpu_torch.io import weights as tweights
from qwen3_tts_tpu_torch.models import talker as ttk
from qwen3_tts_tpu_torch.models import transformer as ttfm

torch.set_num_threads(1)

JCFG = C.tiny_tts_config().talker
TCFG = pconfig.tiny_tts_config().talker
GEO = jtfm.geometry_of(JCFG)
PGEO = ttfm.geometry_of(TCFG)
S = TCFG.max_seq_len
TOL = dict(rtol=2e-4, atol=2e-4)      # the JAX test's


def _np(tree):
    """JAX params -> numpy, each QTensor as (q, scale)."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items() if k != "layers_list"}
    if isinstance(tree, jquant.QTensor):
        return (np.asarray(tree.q), np.asarray(tree.scale))
    return np.asarray(tree)


@pytest.fixture(scope="module")
def talkers():
    """{"f32" | "int8": (JAX talker, port talker)}: one f32 draw, and its
    fused int8 stack quantized by JAX and carried across."""
    jp = jweights.init_random_params(C.tiny_tts_config(), seed=3,
                                     dtype=jnp.float32)["talker"]
    out = {}
    for kind in ("f32", "int8"):
        j = jquant.quantize_talker(jp) if kind == "int8" else jp
        out[kind] = (j, tweights.from_jax_numpy({"t": _np(j)})["t"])
    return out


def _prefix(talkers, kind, n_text, n_pad):
    """The dual-stream prefix of ids 1..n_pad with n_text real tokens,
    built by each package from its own weights: (JAX, port) each as
    (prefix (1, P, H), lengths (1,))."""
    jt, tt = talkers[kind]
    ids = np.arange(1, n_pad + 1, dtype=np.int32)
    jpre, jlen = jtk.build_prefix(jt, jnp.asarray(ids), jnp.int32(n_text))
    tpre, tlen = ttk.build_prefix(tt, torch.from_numpy(ids), n_text)
    return (jpre[None], jlen[None]), (tpre[None], tlen.reshape(1))


# (n_text, n_pad, chunk): the JAX test's three cases, 25 rows in 8-row
# windows (a padded last window), 17 in 4s, and 25 in 7s
CASES = [(12, 16, 8), (5, 8, 4), (4, 16, 7)]


@pytest.mark.parametrize("kind", ["f32", "int8"])
@pytest.mark.parametrize("n_text,n_pad,chunk", CASES,
                         ids=[f"chunk{c[2]}" for c in CASES])
def test_prefill_chunked_matches_jax(talkers, kind, n_text, n_pad, chunk):
    """The hidden at the last real row and the real KV rows, against JAX's
    chunked prefill; then one decode step from each cache on the same
    feedback row. The int8 decode step is K3's plain version in the port
    and an XLA step in JAX, whose RMSNorm rounds in another order (an
    expected divergence of the port), so there the port's step after the
    chunked prefill is held to its step after the one-shot prefill
    (test_prefill_chunked_matches_one_shot)."""
    jt, tt = talkers[kind]
    (jpre, jlen), (tpre, tlen) = _prefix(talkers, kind, n_text, n_pad)
    jh, jkv = jtk.prefill_chunked(jt, jpre, jlen,
                                  jtfm.init_kv_cache(GEO, 1, S), JCFG,
                                  chunk=chunk)
    th, tkv = ttk.prefill_chunked(tt, tpre, tlen,
                                  ttfm.init_kv_cache(PGEO, 1, S), TCFG,
                                  chunk=chunk)
    P = int(tlen[0])
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tkv[:, :, :, :P].numpy(),
                               np.asarray(jkv[:, :, :, :P]), **TOL)
    if kind == "int8":
        return
    fb = np.random.default_rng(5).standard_normal(
        (1, JCFG.hidden_size)).astype(np.float32) * 0.3
    jh2, _ = jtk.decode_step(jt, jnp.asarray(fb), jlen, jkv, JCFG)
    th2, _ = ttk.decode_step(tt, torch.from_numpy(fb), tlen.long(), tkv,
                             TCFG)
    np.testing.assert_allclose(th2.numpy(), np.asarray(jh2), **TOL)


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_prefill_chunked_matches_one_shot(talkers, kind):
    """Against the port's one-shot prefill (in 7-row windows, a padded
    last one): the hidden and the real KV rows, and a decode step from
    each cache."""
    _, tt = talkers[kind]
    _, (tpre, tlen) = _prefix(talkers, kind, 4, 16)
    h1, kv1 = ttk.prefill(tt, tpre, tlen, ttfm.init_kv_cache(PGEO, 1, S),
                          TCFG)
    h2, kv2 = ttk.prefill_chunked(tt, tpre, tlen,
                                  ttfm.init_kv_cache(PGEO, 1, S), TCFG,
                                  chunk=7)
    P = int(tlen[0])
    np.testing.assert_allclose(h2.numpy(), h1.numpy(), **TOL)
    np.testing.assert_allclose(kv2[:, :, :, :P].numpy(),
                               kv1[:, :, :, :P].numpy(), **TOL)
    fb = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (1, TCFG.hidden_size)).astype(np.float32) * 0.3)
    d1, _ = ttk.decode_step(tt, fb, tlen.long(), kv1, TCFG)
    d2, _ = ttk.decode_step(tt, fb, tlen.long(), kv2, TCFG)
    np.testing.assert_allclose(d2.numpy(), d1.numpy(), **TOL)


def test_prefill_chunked_rejects_overflowing_window(talkers):
    """A window grid past the cache's S raises before any write, as
    JAX's does (its dynamic_update_slice would clamp the last window's
    offset onto real rows)."""
    _, tt = talkers["f32"]
    kv = ttfm.init_kv_cache(PGEO, 1, S)
    P = S - 2                 # pads to 2 windows of 100 > S = 128
    prefix = torch.zeros((1, P, TCFG.hidden_size))
    with pytest.raises(ValueError, match="chunked prefill"):
        ttk.prefill_chunked(tt, prefix, torch.tensor([P - 1]), kv, TCFG,
                            chunk=100)
    assert not kv.any()
    with pytest.raises(ValueError, match="forward_window"):
        ttfm.forward_window(tt["layers"], prefix[:, :8], S - 4, kv, PGEO)
