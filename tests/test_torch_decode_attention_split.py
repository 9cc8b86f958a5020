"""K5's split design on the CPU: the plain version of
``decode_attention`` (positions cut into ``nsplit`` chunks of WARPS
sub-chunks, a partial softmax per sub-chunk, merged per chunk and then
over the chunks in order) against the JAX package's
``decode_attention_pallas`` in interpret mode, at split counts 1, 3 and
8, with positions 0, S-1 and on chunk boundaries; the wrapper's shape
rules. Inputs are drawn with numpy from fixed seeds. Tolerance
rtol 1e-5 / atol 1e-6, as in tests/test_torch_attention.py: the same f32
math in another summation order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qwen3_tts_tpu.ops.pallas import decode_attention as jda
from qwen3_tts_tpu_torch.ops.kernels import decode_attention as tda

torch.set_num_threads(1)


def _inputs(seed, B, Hq, Hkv, Dh, S):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, Dh)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32)
    return q, k, v


def _pallas(q, k, v, pos):
    return np.asarray(jda.decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        interpret=True))


@pytest.mark.parametrize("geo", [(8, 4, 16), (8, 1, 32)],
                         ids=["G2-Dh16", "G8-Dh32"])
@pytest.mark.parametrize("nsplit", [1, 3, 8])
def test_decode_attention_split_matches_pallas(nsplit, geo):
    """B = 4, S = 24: pos 0 (every split but the first empty), S-1, the
    first position of the second chunk and the last of the first."""
    Hq, Hkv, Dh = geo
    B, S = 4, 24
    q, k, v = _inputs(nsplit, B, Hq, Hkv, Dh, S)
    C = -(-S // nsplit)
    pos = np.array([0, S - 1, min(C, S - 2), C - 1], np.int32)
    got = tda.decode_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v),
                                     torch.from_numpy(pos), nsplit=nsplit)
    assert got.shape == (B, Hq * Dh) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _pallas(q, k, v, pos), rtol=1e-5,
                               atol=1e-6)


def test_decode_attention_plain_past_the_old_shared_memory_cap():
    """S = 4096 at Dh = 8: the old kernel kept G x S scores in shared
    memory and refused S past ~48 KB of it; the split design keeps a
    warp's sub-chunk of them."""
    B, Hq, Hkv, Dh, S = 2, 2, 1, 8, 4096
    q, k, v = _inputs(7, B, Hq, Hkv, Dh, S)
    pos = np.array([S - 1, 1500], np.int32)
    got = tda.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), _pallas(q, k, v, pos), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("nsplit", [1, 8])
def test_decode_attention_plain_ignores_rows_past_pos(nsplit):
    """Rows past pos poisoned (+-99 in K and V, NaN in V) change no bit."""
    B, Hq, Hkv, Dh, S = 3, 8, 4, 16, 40
    q, k, v = (torch.from_numpy(a) for a in _inputs(11, B, Hq, Hkv, Dh, S))
    pos = torch.tensor([0, 17, S - 1])
    want = tda.decode_attention_plain(q, k, v, pos, nsplit=nsplit)
    for b, p in enumerate(pos.tolist()):
        k[b, p + 1:] = 99.0
        v[b, p + 1:] = -99.0
        v[b, p + 2:] = float("nan")
    got = tda.decode_attention_plain(q, k, v, pos, nsplit=nsplit)
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", [(2, 16, 1, 16), (2, 8, 4, 12),
                                   (2, 8, 4, 512), (2, 8, 4, 48)],
                         ids=["G16", "Dh12", "Dh512", "Dh48"])
def test_decode_attention_cuda_refuses_what_the_kernel_does_not_take(shape):
    """At most 8 query heads a kv head; Dh a multiple of 8 with Dh / 8 a
    power of two, at most 256. The wrapper raises before it looks for a
    card."""
    B, Hq, Hkv, Dh = shape
    q, k, v = (torch.from_numpy(a) for a in _inputs(0, B, Hq, Hkv, Dh, 8))
    with pytest.raises(ValueError, match="heads|head dim"):
        tda.decode_attention_cuda(q, k, v, torch.zeros(B, dtype=torch.long))
