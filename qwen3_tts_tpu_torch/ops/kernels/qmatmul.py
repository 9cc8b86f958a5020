"""K1: weight-only int8 matmul (csrc/qmatmul.cu), replacing the TPU
kernel qwen3_tts_tpu/ops/pallas/qmatmul.py :: qmatmul_pallas.

x (M, K) bf16/f32 @ q (K, N) int8 -> (M, N) f32: x rounded to bf16, the
int8 weight converted to bf16 in registers, f32 accumulation, times the
f32 per-column scale. Any M (decode rows and prefill rows alike).

Two hand-written routes, chosen by shape alone (``route``), each with its
own launch count:
- decode rows (1 <= M <= 8, K <= 3072 and a multiple of 8, every N a
  multiple of 16): ``qmatmul_qsplit``, the cluster-split product of K2 and
  K3 under programmatic dependent launch, with up to three weights that
  share x in one launch (``qmatmul_group``). It adds up in qsplit's order,
  so its outputs equal ``qmatmul_plain`` (ops/kernels/common.qmm) bit for
  bit, and a group's outputs are those of one product a weight;
- any other shape with N % 8 == 0 and K % 16 == 0 (prefill rows):
  ``qmatmul_tile``, the tensor-core tile, one launch a weight. The order
  inside an MMA is the hardware's, so it is held to a bound instead:
  ``qmatmul_error`` <= ``TILE_TOL`` against the product summed in float64.
The plain version is ``qmatmul_plain`` for both."""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch

from qwen3_tts_tpu_torch.ops.kernels import _build
from qwen3_tts_tpu_torch.ops.kernels.common import qmm

QS_MAXR = 8           # rows a qsplit launch takes (QS_MAXR in common.cuh)
QS_MAXSEG = 3         # weights a qsplit launch takes (QS_MAXSEG)
# the widest K whose staged weight rows, x values and partial sums fit a
# qsplit block's shared memory (QS_MAX_SMEM) at any cluster size and R
QS_MAXK = 3072
# the tile's bound on the normalised error (qmatmul_error) of any output
TILE_TOL = 2.0 ** -16

Weight = Tuple[torch.Tensor, torch.Tensor]    # (q (K, N) int8, scale (N,))


def qmatmul_plain(x: torch.Tensor, q: torch.Tensor,
                  scale: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version (both routes)."""
    return qmm(x, q, scale)


def qmatmul_error(out: torch.Tensor, x: torch.Tensor, q: torch.Tensor,
                  scale: torch.Tensor) -> float:
    """The largest normalised error of a K1 output (M, N):
    |out[r, n] - ref64[r, n]| / (scale[n] * sum_k |bf16(x[r, k]) q[k, n]|),
    ref64 the product summed in float64 (every term exact). A dropped,
    swapped or misindexed term gives 1e-2 or more; f32 accumulation in
    any order about 1e-7."""
    xb = x.to(torch.bfloat16).double()
    qd, sd = q.double(), scale.double()
    ref = (xb @ qd) * sd
    den = (xb.abs() @ qd.abs()) * sd.abs()
    err = (out.double() - ref).abs()
    norm = torch.where(den > 0, err / den,
                       torch.where(err > 0, float("inf"), 0.0))
    return float(norm.max()) if norm.numel() else 0.0


def on_qsplit(M: int, K: int, Ns: Sequence[int]) -> bool:
    """Whether a group of weights (K, N) sharing M rows is one qsplit
    launch (else each weight goes by its own ``route``)."""
    return (1 <= M <= QS_MAXR and 1 <= K <= QS_MAXK and K % 8 == 0
            and 1 <= len(Ns) <= QS_MAXSEG and all(N % 16 == 0 for N in Ns))


def route(M: int, K: int, N: int) -> str:
    """The route of one weight (K, N) at M rows: "qsplit" or "tile";
    ValueError for a shape neither takes."""
    if on_qsplit(M, K, [N]):
        return "qsplit"
    if K % 16 or N % 8 or K < 16 or N < 8:
        raise ValueError(f"qmatmul: ({M},{K})x({K},{N}) is on the tile, "
                         f"which needs K % 16 == 0 and N % 8 == 0")
    return "tile"


def _operands(x: torch.Tensor, ws: Sequence[Weight]):
    """Check a group's operands (each weight's shape on a ``route``); x
    contiguous and 16-byte aligned (both routes copy its rows 16 bytes at
    a time), the weights contiguous."""
    M, K = x.shape
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"qmatmul: x must be bf16 or f32, got {x.dtype}")
    out = []
    for q, s in ws:
        N = q.shape[1]
        if q.shape[0] != K or s.shape != (N,):
            raise ValueError(f"qmatmul: shapes x{tuple(x.shape)} "
                             f"q{tuple(q.shape)} scale{tuple(s.shape)}")
        if q.dtype != torch.int8 or s.dtype != torch.float32:
            raise TypeError("qmatmul: q must be int8 and scale f32")
        if not (q.device == x.device and s.device == x.device):
            raise ValueError("qmatmul: q and scale must be on the card "
                             "with x")
        route(M, K, N)
        out.append((q.contiguous(), s.contiguous()))
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    return x, out


def qmatmul_qsplit(x: torch.Tensor, ws: Sequence[Weight]) -> list:
    """The decode-row route: one qsplit launch for up to QS_MAXSEG
    weights sharing x (operands as ``_operands`` returns them)."""
    M, K = x.shape
    outs = [torch.empty((M, q.shape[1]), dtype=torch.float32,
                        device=x.device) for q, _ in ws]
    segs = []
    for i in range(QS_MAXSEG):
        if i < len(ws):
            q, s = ws[i]
            segs += [q.data_ptr(), s.data_ptr(), outs[i].data_ptr(),
                     q.shape[1]]
        else:
            segs += [None, None, None, 0]
    _split_fn()(x.data_ptr(), int(x.dtype == torch.bfloat16), M, K, len(ws),
                *segs, _build.stream())
    qmatmul_qsplit.launches += 1
    qmatmul.launches += 1
    return outs


def qmatmul_tile(x: torch.Tensor, q: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """The prefill-row route: one launch of the tensor-core tile, any M
    (operands as ``_operands`` returns them)."""
    M, K = x.shape
    N = q.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    _tile_fn()(x.data_ptr(), int(x.dtype == torch.bfloat16), q.data_ptr(),
               scale.data_ptr(), out.data_ptr(), M, K, N, _build.stream())
    qmatmul_tile.launches += 1
    qmatmul.launches += 1
    return out


def qmatmul_group(x: torch.Tensor, ws: Sequence[Weight]) -> list:
    """[x @ w for w in ws] for int8 weights (q, scale) that share x, each
    (M, N_i) f32: their plain versions on a CPU tensor; on a CUDA tensor
    one qsplit launch for the group where ``on_qsplit`` takes it, else
    each weight by its own ``route``."""
    if x.device.type == "cpu":
        return [qmatmul_plain(x, q, s) for q, s in ws]
    if not x.is_cuda:
        raise ValueError(f"qmatmul: unsupported device {x.device}")
    x, ws = _operands(x, ws)
    M, K = x.shape
    if on_qsplit(M, K, [q.shape[1] for q, _ in ws]):
        return qmatmul_qsplit(x, ws)
    return [qmatmul_qsplit(x, [(q, s)])[0]
            if route(M, K, q.shape[1]) == "qsplit" else qmatmul_tile(x, q, s)
            for q, s in ws]


def qmatmul(x: torch.Tensor, q: torch.Tensor,
            scale: torch.Tensor) -> torch.Tensor:
    """K1 on a CUDA tensor (by its route); its plain version on a CPU
    tensor."""
    return qmatmul_group(x, [(q, scale)])[0]


qmatmul.launches = 0           # every K1 launch, both routes
qmatmul_qsplit.launches = 0
qmatmul_tile.launches = 0


@functools.cache
def _tile_fn():
    return _build.function("q3_qmatmul_tile", "pipppiiip")


@functools.cache
def _split_fn():
    return _build.function("q3_qmatmul_split",
                           "piiii" + "pppi" * QS_MAXSEG + "p")
