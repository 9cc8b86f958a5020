"""Plain PyTorch versions of the device primitives in csrc/common.cuh,
shared by the plain versions of K1, K2 and K3. Twin of
qwen3_tts_tpu/ops/pallas/common.py (K0).

The plain versions add up in the kernels' order: each reduction below
says which CUDA loop it follows (a thread's sequential fma chain, the
xor-butterfly of a warp, warps in index order). So on the card a plain
version and its kernel agree bit for bit wherever both call the same
correctly rounded operations; without that, the f32 rounding noise of
another summation order flips bf16 roundings, and 28 talker layers
amplify the flips past any fixed tolerance. sqrt and division are
correctly rounded on both sides; exp and log are the CUDA libm's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# masking constant for attention and sampling (Q3_NEG in common.cuh)
NEG = -1e30
WARP = 32
QMM_KSLICES = 128     # k-slices of a qmm tile (QMM_KSLICES in common.cuh)
ATT_THREADS = 512     # attention block threads (ATT_THREADS in common.cuh)


def bf16(x: torch.Tensor) -> torch.Tensor:
    """Round through bf16, kept as f32."""
    return x.to(torch.bfloat16).float()


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """CUDA fmaf: a * b + c rounded once to f32. In f64 the product is
    exact, and the f64 sum rounds to a different f32 only at an f32 tie."""
    return (a.double() * b.double() + c.double()).float()


def _pad_last(x: torch.Tensor, multiple: int) -> torch.Tensor:
    n = x.shape[-1]
    return F.pad(x, (0, -n % multiple))


def warp_sum(v: torch.Tensor) -> torch.Tensor:
    """warp_sum over the last dim (32 lanes): the xor butterfly, whose
    lane 0 ends with the pairwise tree (l + l^16), then ^8, ^4, ^2, ^1."""
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    return v[..., 0]


def block_sum(v: torch.Tensor) -> torch.Tensor:
    """block_sum over the last dim (one value per thread): warp trees,
    then the warps' sums added in index order."""
    w = warp_sum(_pad_last(v, WARP).unflatten(-1, (-1, WARP)))
    t = w[..., 0]
    for i in range(1, w.shape[-1]):
        t = t + w[..., i]
    return t


def lane_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum(a * b) over the last dim as one warp does it: lane j runs an
    fma chain over elements j, j + 32, ..., then warp_sum."""
    a = _pad_last(a, WARP).unflatten(-1, (-1, WARP))
    b = _pad_last(b, WARP).unflatten(-1, (-1, WARP))
    acc = torch.zeros_like(a[..., 0, :])
    for j in range(a.shape[-2]):
        acc = fma(a[..., j, :], b[..., j, :], acc)
    return warp_sum(acc)


def _inv_rms(sumsq: torch.Tensor, d: int, eps: float) -> torch.Tensor:
    """1 / sqrt(sumsq / d + eps), each step correctly rounded."""
    return 1.0 / torch.sqrt(sumsq / d + eps)


def rms_rows(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """K0 rms of the qmm prologue: RMSNorm of rows x (R, D) entirely in
    f32 (NOT the HF cast order of models/transformer.rms_norm), one warp
    per row. Returns f32."""
    x = x.float()
    ss = lane_dot(x, x)
    return x * _inv_rms(ss, x.shape[-1], eps)[..., None] * w.float()


def rms_heads(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """K0 rms of the attention kernels: per-head RMSNorm over the last
    dim, one thread per element (squares rounded, then block_sum)."""
    x = x.float()
    ss = block_sum(_pad_last(x * x, ATT_THREADS))
    return x * _inv_rms(ss, x.shape[-1], eps)[..., None] * w.float()


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """HF convention: concat(-x[d/2:], x[:d/2]) on the last axis."""
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """K0 rot_mat: x * cos + rotate_half(x) * sin, in f32."""
    return x * cos + rotate_half(x) * sin


def qmm(x: torch.Tensor, w: torch.Tensor,
        s: torch.Tensor = None) -> torch.Tensor:
    """K0 qmm: bf16(x) (R, K) @ bf16(w) (K, N) [* per-column scale s]
    -> f32 (R, N), summed as qmm_tile does: k-slice ks runs over
    k = ks, ks + QMM_KSLICES, ... (each product of a bf16 and an int8 or
    bf16 is exact in f32), slices 4g..4g+3 add pairwise, and the groups
    add in order. w is int8 (with s) or a dense float weight (rounded to
    bf16)."""
    R, K = x.shape
    xb = _pad_last(bf16(x.float()), QMM_KSLICES)
    wb = w.float() if w.dtype == torch.int8 else bf16(w.float())
    wb = F.pad(wb, (0, 0, 0, xb.shape[1] - K))
    J = xb.shape[1] // QMM_KSLICES
    xs = xb.reshape(R, J, QMM_KSLICES)
    ws = wb.reshape(J, QMM_KSLICES, -1)
    acc = xs[:, 0, :].T[:, :, None] * ws[0][:, None, :]     # (KS, R, N)
    for j in range(1, J):
        acc = acc + xs[:, j, :].T[:, :, None] * ws[j][:, None, :]
    a = acc.reshape(QMM_KSLICES // 4, 4, R, -1)
    per_warp = (a[:, 0] + a[:, 1]) + (a[:, 2] + a[:, 3])
    out = per_warp[0]
    for i in range(1, per_warp.shape[0]):
        out = out + per_warp[i]
    return out if s is None else out * s.float()


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(-x)), as the kernels compute it."""
    return 1.0 / (1.0 + torch.exp(-x))


def softmax_sum(e: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim (positions) as the attention kernels do:
    thread t adds positions t, t + ATT_THREADS, ... in order, then
    block_sum."""
    e = _pad_last(e, ATT_THREADS).unflatten(-1, (-1, ATT_THREADS))
    t = e[..., 0, :]
    for j in range(1, e.shape[-2]):
        t = t + e[..., j, :]
    return block_sum(t)


def pv(p: torch.Tensor, v: torch.Tensor, n: int) -> torch.Tensor:
    """out[..., d] = sum_s p[..., s] * v[..., s, d] for s < n, one fma
    chain per output in position order (the attention kernels' P.V).
    p (..., S); v (..., S, D)."""
    acc = torch.zeros_like(v[..., 0, :])
    for si in range(n):
        acc = fma(p[..., si, None], v[..., si, :], acc)
    return acc


# ---------------------------------------------------------------------------
# K5's reductions (csrc/decode_attention.cu): 8-wide lane chains for the
# scores, a warp's strided chains for each sub-chunk's softmax sum, masked
# P.V chains, and the ordered merge of partial softmaxes (a block's warps,
# then the cluster's blocks).
# ---------------------------------------------------------------------------

ROW_VEC = 8           # elements of a lane's dot chain (DA_VEC)


def row_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum(a * b) over the last dim D as K5's lane groups do it: D / 8
    lanes, lane l an fma chain over elements 8l .. 8l + 7 in order, then
    the xor butterfly over the D / 8 lanes (D / 8 a power of two)."""
    a = a.unflatten(-1, (-1, ROW_VEC))
    b = b.unflatten(-1, (-1, ROW_VEC))
    acc = torch.zeros_like(a[..., 0])
    for j in range(ROW_VEC):
        acc = fma(a[..., j], b[..., j], acc)
    return warp_sum(acc)


def lane_sum(e: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim as one warp does it: lane j adds elements
    j, j + 32, ... in order, then warp_sum."""
    e = _pad_last(e, WARP).unflatten(-1, (-1, WARP))
    t = e[..., 0, :]
    for j in range(1, e.shape[-2]):
        t = t + e[..., j, :]
    return warp_sum(t)


def pv_valid(e: torch.Tensor, v: torch.Tensor,
             valid: torch.Tensor) -> torch.Tensor:
    """out[..., d] = sum_s e[..., s] * v[..., s, d] over the positions
    where ``valid`` holds, one fma chain per output in position order;
    the other positions are not read. e (..., n); v (..., n, D); valid
    broadcasts against e."""
    acc = torch.zeros(torch.broadcast_shapes(e.shape[:-1] + (1,),
                                             v.shape[:-2] + v.shape[-1:]),
                      dtype=torch.float32, device=v.device)
    for si in range(e.shape[-1]):
        acc = torch.where(valid[..., si, None],
                          fma(e[..., si, None], v[..., si, :], acc), acc)
    return acc


def merge_partials(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor,
                   live: torch.Tensor):
    """K5's merge of partial softmaxes i over the ones where ``live``
    holds: M = max m_i, w_i = exp(m_i - M), L = sum_i l_i * w_i and
    O = sum_i w_i * o_i, each sum an fma chain in index order. m, l
    (N, ...); o (N, ..., D); live broadcasts against m. Returns (M, L, O);
    the attention is O / L."""
    live = live.expand(m.shape)
    M = torch.where(live, m, torch.full_like(m, -torch.inf)).amax(0)
    L = torch.zeros_like(M)
    O = torch.zeros_like(o[0])
    for i in range(m.shape[0]):
        w = torch.exp(m[i] - M)
        L = torch.where(live[i], fma(l[i], w, L), L)
        O = torch.where(live[i][..., None], fma(w[..., None], o[i], O), O)
    return M, L, O
