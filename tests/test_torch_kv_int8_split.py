"""K6's split design on the CPU: the plain version of
``decode_attention_kv_int8`` (K5's plain version over the dequantized
rows: positions cut into ``nsplit`` chunks of WARPS sub-chunks, a partial
softmax per sub-chunk, merged per chunk and then over the chunks in
order) against the JAX package's ``decode_attention_kv_int8`` in
interpret mode, on ragged chunks and sub-chunks (S no multiple of 32),
with positions 0, S-1 and on chunk and sub-chunk edges; the wrapper's
shape rules. Inputs are drawn with numpy from fixed seeds and quantized
by the JAX package. Tolerance as tests/test_torch_kv_int8.py states it:
rtol = atol = 2e-5 for f32 q (the same f32 math in another summation
order), one bf16 ulp for bf16 q, and for bf16 outputs that cancel to
near 0 the f32 atol of 2e-5 (one ulp there is below the f32 rounding of
the sums that cancel).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qwen3_tts_tpu.ops.pallas import kv_int8 as jkv
from qwen3_tts_tpu_torch.ops.kernels import kv_int8 as tkv
from qwen3_tts_tpu_torch.ops.kernels.decode_attention import NSPLIT, WARPS

torch.set_num_threads(1)

HKV = 2


def _t(a):
    return torch.from_numpy(np.array(a))


def _case(seed, B, G, Dh, S):
    """q (B, G * HKV, Dh) f32 and the JAX-quantized int8 cache."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, G * HKV, Dh)).astype(np.float32)
    kf = (rng.standard_normal((B, HKV, S, Dh)) * 0.5).astype(np.float32)
    vf = (rng.standard_normal((B, HKV, S, Dh)) * 0.5).astype(np.float32)
    kq, ks = (np.asarray(a) for a in jkv.quantize_kv_rows(jnp.asarray(kf)))
    vq, vs = (np.asarray(a) for a in jkv.quantize_kv_rows(jnp.asarray(vf)))
    return q, kq, ks, vq, vs


def _edges(S):
    """Positions 0 and S-1, the last of the first chunk and the first of
    the second, and the last position of the first chunk's first
    sub-chunk."""
    C = -(-S // NSPLIT)
    W = -(-C // WARPS)
    return [0, S - 1, C - 1, min(C, S - 1), W - 1]


def _assert_close(got, want, qdtype):
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    if qdtype == "f32":
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    else:
        # one bf16 ulp of the output; where an output cancels to near 0
        # (|out| < ~2.5e-3) its ulp falls below the f32 sums' own rounding,
        # and the f32 bound's atol holds instead
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        bound = np.maximum(ulp, 2e-5)
        assert (np.abs(got - want) <= bound).all(), np.abs(got - want).max()


def _both(q, kq, ks, vq, vs, pos, qdtype, pos_dtype, **kw):
    """(the port's plain version, the Pallas kernel in interpret mode) on
    the same inputs."""
    jq = jnp.asarray(q, jnp.bfloat16) if qdtype == "bf16" else jnp.asarray(q)
    tq = _t(q).bfloat16() if qdtype == "bf16" else _t(q)
    want = jkv.decode_attention_kv_int8(
        jq, jnp.asarray(kq), jnp.asarray(ks), jnp.asarray(vq), jnp.asarray(vs),
        jnp.asarray(pos, jnp.int32), interpret=True)
    got = tkv.decode_attention_kv_int8_plain(
        tq, _t(kq), _t(ks), _t(vq), _t(vs), torch.tensor(pos, dtype=pos_dtype),
        **kw)
    return got, want


@pytest.mark.parametrize("S", [24, 77, 130])
@pytest.mark.parametrize("Dh", [16, 64])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
def test_kv_int8_split_plain_matches_pallas(G, Dh, S):
    """B = 5 rows at positions 0, S-1 and chunk and sub-chunk edges; f32
    q with int64 pos, then bf16 q with int32 pos."""
    q, kq, ks, vq, vs = _case(G * 1000 + Dh * 10 + S, 5, G, Dh, S)
    pos = _edges(S)
    for qdtype, pos_dtype in (("f32", torch.int64), ("bf16", torch.int32)):
        got, want = _both(q, kq, ks, vq, vs, pos, qdtype, pos_dtype)
        assert got.shape == (5, G * HKV * Dh)
        assert got.dtype == (torch.bfloat16 if qdtype == "bf16"
                             else torch.float32)
        _assert_close(got, want, qdtype)


@pytest.mark.parametrize("qdtype", ["f32", "bf16"])
def test_kv_int8_split_nsplit_1_and_8_agree(qdtype):
    """The split changes only the summation order: one chunk of one warp's
    worth against 8 chunks, within the tolerance against each other and
    against the Pallas kernel."""
    q, kq, ks, vq, vs = _case(21, 4, 2, 16, 77)
    pos = [0, 76, 9, 40]
    one, want = _both(q, kq, ks, vq, vs, pos, qdtype, torch.int32, nsplit=1)
    eight, _ = _both(q, kq, ks, vq, vs, pos, qdtype, torch.int32, nsplit=8)
    _assert_close(one, want, qdtype)
    _assert_close(eight, want, qdtype)
    _assert_close(one, jnp.asarray(eight.float().numpy()), qdtype)


@pytest.mark.parametrize("nsplit", [1, 8])
def test_kv_int8_split_ignores_rows_past_pos(nsplit):
    """Rows past pos set to +-99 before quantizing change no bit."""
    rng = np.random.default_rng(5)
    B, G, Dh, S = 3, 4, 16, 77
    q = _t(rng.standard_normal((B, G * HKV, Dh)).astype(np.float32))
    kf = _t(rng.standard_normal((B, HKV, S, Dh)).astype(np.float32))
    vf = _t(rng.standard_normal((B, HKV, S, Dh)).astype(np.float32))
    pos = torch.tensor([9, 0, 50])

    def run(kf, vf):
        return tkv.decode_attention_kv_int8_plain(
            q, *tkv.quantize_kv_rows(kf), *tkv.quantize_kv_rows(vf), pos,
            nsplit=nsplit)

    want = run(kf, vf)
    for b, p in enumerate(pos.tolist()):
        kf[b, :, p + 1:] = 99.0
        vf[b, :, p + 1:] = -99.0
    assert torch.equal(run(kf, vf), want)


def test_kv_int8_split_past_the_old_shared_memory_cap():
    """S = 8192 at tiny widths: the old kernel kept G x S scores in shared
    memory and refused S past ~3900 at G = 2; the split keeps a warp's
    sub-chunk of them. The plain version against the Pallas kernel."""
    q, kq, ks, vq, vs = _case(8, 2, 2, 16, 8192)
    got, want = _both(q, kq, ks, vq, vs, [8191, 3000], "f32", torch.int32)
    _assert_close(got, want, "f32")


def _args(B=2, G=2, Hkv=2, Dh=16, S=8):
    """CPU operands of decode_attention_kv_int8_cuda."""
    q = torch.zeros((B, G * Hkv, Dh))
    kq = torch.zeros((B, Hkv, S, Dh), dtype=torch.int8)
    ks = torch.ones((B, Hkv, S))
    return [q, kq, ks, kq.clone(), ks.clone(), torch.zeros(B, dtype=torch.long)]


def _noncontiguous():
    a = _args()
    a[1] = torch.zeros((2, 2, 16, 8), dtype=torch.int8).transpose(2, 3)
    return a


def _scale_shape():
    a = _args()
    a[4] = torch.ones((2, 2, 9))
    return a


@pytest.mark.parametrize("make,match", [
    (lambda: _args(G=9, Hkv=1), "query heads"),
    (lambda: _args(Dh=8), "head dim"),
    (lambda: _args(Dh=48), "head dim"),
    (lambda: _args(Dh=512), "head dim"),
    (_noncontiguous, "contiguous"),
    (_scale_shape, "scales"),
], ids=["G9", "Dh8-off-16", "Dh48-not-2^k", "Dh512", "noncontiguous",
        "scale-shape"])
def test_kv_int8_cuda_refuses_what_the_kernel_does_not_take(make, match):
    """At most 8 query heads a kv head; Dh a multiple of 16 whose Dh / 8 is
    a power of two at most 32; a contiguous cache; scales (B, Hkv, S).
    The wrapper raises before it looks for a card."""
    with pytest.raises(ValueError, match=match):
        tkv.decode_attention_kv_int8_cuda(*make())
