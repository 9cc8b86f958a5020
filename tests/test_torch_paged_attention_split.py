"""K4 as K5's split behind the page table, on the CPU: the plain version
of ``paged_attention`` (K5's chunks, warp sub-chunks and ordered merges
over the positions 0 .. MAXP*psz - 1 of the rows the table gathers)
against the JAX package's ``paged_decode_attention_pallas`` in interpret
mode, and bit for bit against ``decode_attention_plain`` over
``paged_gather_kv`` rows: positions on page edges and on chunk edges
(chunks of ceil(MAXP*psz / 8), not a multiple of the page size), a
one-page row whose other table entries are the reserved page 0, MAXP not
a multiple of 8; the wrapper's shape rules. Inputs are drawn with numpy
from fixed seeds. Tolerance against JAX rtol 2e-5 / atol 2e-6, as in
tests/test_torch_attention.py: the same f32 math in another summation
order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qwen3_tts_tpu.ops.pallas import paged_attention as jpa
from qwen3_tts_tpu_torch.ops.kernels import decode_attention as tda
from qwen3_tts_tpu_torch.ops.kernels import paged_attention as tpa

torch.set_num_threads(1)


def _case(seed, B, Hq, Hkv, Dh, psz, MAXP, P=None):
    """q (B, Hq, Dh), pool (2, P, psz, Hkv, Dh) and a scrambled table of
    pages 1 .. P-1 (page 0 stays the reserved page)."""
    rng = np.random.default_rng(seed)
    P = P or B * MAXP + 3
    q = (rng.standard_normal((B, Hq, Dh)) * 0.5).astype(np.float32)
    pool = (rng.standard_normal((2, P, psz, Hkv, Dh)) * 0.5
            ).astype(np.float32)
    table = rng.permutation(np.arange(1, P))[:B * MAXP].reshape(B, MAXP)
    return q, pool, table.astype(np.int32)


def _pallas(q, pool, table, pos):
    return np.asarray(jpa.paged_decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(pool[0]), jnp.asarray(pool[1]),
        jnp.asarray(table), jnp.asarray(pos), interpret=True))


def _plain(q, pool, table, pos):
    t = torch.from_numpy
    return tpa.paged_attention_plain(t(q), t(pool[0]), t(pool[1]), t(table),
                                     t(pos))


# (B, Hq, Hkv, Dh, psz, MAXP, pos): S = MAXP*psz, chunks C = ceil(S / 8)
CASES = {
    # S 40, C 5, pages of 8: pos 4 / 5 the chunk edge, 7 / 8 the page edge
    "psz8-MAXP5": (4, 8, 4, 16, 8, 5, [4, 5, 7, 8]),
    # S 48, C 6: pages of 16 straddle chunks; 15 / 16 page edge, 47 last
    "psz16-MAXP3-G8": (3, 8, 1, 32, 16, 3, [15, 16, 47]),
    # S 63, C 8 (W 2): pages of 7 cut every chunk and sub-chunk
    "psz7-MAXP9": (3, 8, 4, 16, 7, 9, [62, 23, 6]),
    # S 576 as the batcher's pages (64 x 9), C 72: chunk edges 71 / 72,
    # page edges 63 / 64 and 575
    "psz64-MAXP9": (4, 4, 2, 16, 64, 9, [71, 72, 63, 575]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_paged_attention_plain_matches_pallas(case):
    B, Hq, Hkv, Dh, psz, MAXP, pl = CASES[case]
    q, pool, table = _case(1, B, Hq, Hkv, Dh, psz, MAXP)
    pos = np.array(pl, np.int32)
    got = _plain(q, pool, table, pos)
    assert got.shape == (B, Hq * Dh) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _pallas(q, pool, table, pos),
                               rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(CASES))
def test_paged_attention_plain_is_dense_plain_over_gathered_rows(case,
                                                                 dtype):
    """Bit for bit, in both dtypes: K4's plain version is K5's over the
    rows the table gathers."""
    B, Hq, Hkv, Dh, psz, MAXP, pl = CASES[case]
    q, pool, table = _case(2, B, Hq, Hkv, Dh, psz, MAXP)
    q, pool = torch.from_numpy(q).to(dtype), torch.from_numpy(pool).to(dtype)
    table, pos = torch.from_numpy(table), torch.tensor(pl)
    got = tpa.paged_attention_plain(q, pool[0], pool[1], table, pos)
    kv = tpa.paged_gather_kv(pool, table)
    assert kv.shape == (2, B, MAXP * psz, Hkv, Dh)
    want = tda.decode_attention_plain(q, kv[0], kv[1], pos)
    assert got.dtype == dtype
    assert torch.equal(got, want)


def test_paged_attention_one_page_row_with_reserved_entries():
    """Row 0 holds one page, the rest of its table is the reserved page
    0; poisoning page 0 (NaN) and every row past each row's pos changes no
    bit, and the result still matches the Pallas kernel."""
    B, Hq, Hkv, Dh, psz, MAXP = 3, 8, 4, 16, 8, 5
    q, pool, table = _case(3, B, Hq, Hkv, Dh, psz, MAXP)
    table[0, 1:] = 0
    pos = np.array([psz - 1, 33, 20], np.int32)
    want = _plain(q, pool, table, pos)
    np.testing.assert_allclose(want.numpy(), _pallas(q, pool, table, pos),
                               rtol=2e-5, atol=2e-6)
    poisoned = pool.copy()
    poisoned[:, 0] = np.nan
    for b, p in enumerate(pos):
        for s in range(p + 1, MAXP * psz):
            if table[b, s // psz]:
                poisoned[:, table[b, s // psz], s % psz] = 99.0
    assert torch.equal(_plain(q, poisoned, table, pos), want)


def test_paged_attention_maxp_not_a_multiple_of_eight():
    """MAXP 3 with pages of 3: S = 9 gives chunks of 2, the last chunk
    one position, and blocks past it empty."""
    B, Hq, Hkv, Dh, psz, MAXP = 2, 4, 2, 8, 3, 3
    q, pool, table = _case(4, B, Hq, Hkv, Dh, psz, MAXP)
    for pl in ([8, 0], [1, 2], [3, 6]):
        pos = np.array(pl, np.int32)
        np.testing.assert_allclose(
            _plain(q, pool, table, pos).numpy(),
            _pallas(q, pool, table, pos), rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("shape", [(2, 16, 1, 16), (2, 8, 4, 12),
                                   (2, 8, 4, 512)],
                         ids=["G16", "Dh12", "Dh512"])
def test_paged_attention_cuda_refuses_what_the_kernel_does_not_take(shape):
    """K5's limits (at most 8 query heads a kv head; Dh a multiple of 8
    with Dh / 8 a power of two, at most 256) and an int32 table: the
    wrapper raises before it looks for a card."""
    B, Hq, Hkv, Dh = shape
    q = torch.zeros((B, Hq, Dh))
    pool = torch.zeros((2, 4, 8, Hkv, Dh))
    table = torch.zeros((B, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="heads|head dim"):
        tpa.paged_attention_cuda(q, pool[0], pool[1], table,
                                 torch.zeros(B, dtype=torch.long))


def test_paged_attention_cuda_refuses_an_int64_table():
    q, pool = torch.zeros((2, 8, 16)), torch.zeros((2, 4, 8, 4, 16))
    with pytest.raises(ValueError, match="table"):
        tpa.paged_attention_cuda(q, pool[0], pool[1],
                                 torch.zeros((2, 2), dtype=torch.long),
                                 torch.zeros(2, dtype=torch.long))
