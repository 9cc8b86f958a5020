"""K1: weight-only int8 matmul (csrc/qmatmul.cu), replacing the TPU
kernel qwen3_tts_tpu/ops/pallas/qmatmul.py :: qmatmul_pallas.

x (M, K) bf16/f32 @ q (K, N) int8 -> (M, N) f32: x rounded to bf16, the
int8 weight converted to bf16 in registers, f32 accumulation, times the
f32 per-column scale. Any M (decode rows and prefill rows alike)."""

from __future__ import annotations

import functools

import torch

from qwen3_tts_tpu_torch.ops.kernels import _build
from qwen3_tts_tpu_torch.ops.kernels.common import qmm


def qmatmul_plain(x: torch.Tensor, q: torch.Tensor,
                  scale: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version."""
    return qmm(x, q, scale)


def qmatmul(x: torch.Tensor, q: torch.Tensor,
            scale: torch.Tensor) -> torch.Tensor:
    """K1 on a CUDA tensor; its plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return qmatmul_plain(x, q, scale)
    if not x.is_cuda:
        raise ValueError(f"qmatmul: unsupported device {x.device}")
    M, K = x.shape
    K2, N = q.shape
    if K2 != K or scale.shape != (N,):
        raise ValueError(f"qmatmul: shapes x{tuple(x.shape)} "
                         f"q{tuple(q.shape)} scale{tuple(scale.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"qmatmul: x must be bf16 or f32, got {x.dtype}")
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError("qmatmul: q must be int8 and scale f32")
    if not (q.is_cuda and scale.is_cuda):
        raise ValueError("qmatmul: q and scale must be on the card with x")
    if N % 8:
        raise ValueError(f"qmatmul: N={N} must be a multiple of 8")
    x, q, scale = x.contiguous(), q.contiguous(), scale.contiguous()
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    _fn()(x.data_ptr(), int(x.dtype == torch.bfloat16), q.data_ptr(),
          scale.data_ptr(), out.data_ptr(), M, K, N, _build.stream())
    qmatmul.launches += 1
    return out


qmatmul.launches = 0


@functools.cache
def _fn():
    return _build.function("q3_qmatmul", "pipppiiip")
