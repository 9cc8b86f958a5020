"""K2's redesign on the CPU (csrc/cp_decode.cu, csrc/common.cuh qsplit):

1. The summation-order contract under the cluster split: ``qmm_split``
   (each block of a cluster runs only its k-slices' chains and group
   sums, then the groups add in order) equals ``qmm`` bit for bit, for
   int8 and bf16 weights, 1-8 rows, K 1024-3072 and 1-8 blocks a cluster.
2. The sampler's radix select: ``radix_threshold`` (4 rounds of 8 bits)
   is the k-th largest sort key, and keeps exactly what
   ``topk_keep_mask`` (the port's and the JAX kernel's) keeps, on rows of
   ties, signed zeros, -inf and equal values.

The kernel's own block map (which block takes which columns and groups)
is held to qmm on the card (tests/test_torch_cuda.py).

Inputs are drawn with numpy from fixed seeds; every comparison is exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qwen3_tts_tpu.ops.pallas import cp_decode as jcp
from qwen3_tts_tpu_torch.ops.kernels import cp_decode as tcp
from qwen3_tts_tpu_torch.ops.kernels.common import qmm, qmm_split

torch.set_num_threads(1)

V = 2048


@pytest.mark.parametrize("wdtype", ["int8", "bf16"])
@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("K", [1024, 2048, 3072])
@pytest.mark.parametrize("R", [1, 4, 8])
def test_qmm_split_equals_qmm(R, K, splits, wdtype):
    rng = np.random.default_rng(R * 7 + K + splits)
    N = 48
    x = torch.from_numpy(rng.standard_normal((R, K)).astype(np.float32))
    if wdtype == "int8":
        w = torch.from_numpy(rng.integers(-127, 128, (K, N)).astype(np.int8))
        s = torch.from_numpy(rng.random(N).astype(np.float32) * 0.01 + 1e-3)
    else:
        w = torch.from_numpy(
            (rng.standard_normal((K, N)) * 0.02).astype(np.float32))
        w, s = w.to(torch.bfloat16), None
    got, want = qmm_split(x, w, s, splits), qmm(x, w, s)
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _logit_rows() -> np.ndarray:
    rng = np.random.default_rng(11)
    lg = (rng.standard_normal((8, V)) * 2).astype(np.float32)
    lg[0] = 0.25                             # all equal
    lg[1, :600] = 1.5                        # a tie across every k below
    lg[2, :700] = 0.0
    lg[2, 700:1400] = -0.0                   # signed zeros
    lg[3] = -np.inf
    lg[3, :5] = 3.0                          # -inf but for five
    lg[4] = -np.abs(lg[4])                   # all negative
    lg[5, ::2] = lg[5, 1::2]                 # pairs of equal values
    lg[6, :60] = np.float32(1e-30)
    lg[6, 60:120] = -np.float32(1e-30)
    return lg


@pytest.mark.parametrize("k", [1, 2, 50, V])
def test_radix_threshold_is_the_topk_threshold(k):
    lg = _logit_rows()
    t = torch.from_numpy(lg)
    key = tcp.sort_keys(t)
    thr = tcp.radix_threshold(t, k)
    kth = key.sort(1, descending=True).values[:, k - 1]
    assert torch.equal(thr[:, 0], kth)
    keep = key >= thr
    assert torch.equal(keep, tcp.topk_keep_mask(t, k))
    np.testing.assert_array_equal(
        keep.numpy(), np.asarray(jcp.topk_keep_mask(jnp.asarray(lg), k)))
