"""K7: the talker decode step over merged weight streams
(csrc/talker_step.cu, K3's entry point given the merged blocks' strides),
replacing the TPU kernel
at tools/dev/microbench_talker_merged.py:307 (``merged_step`` of
``build_step``; kernel body ``_build_merged_kernel``).

The JAX tool asks whether fewer, larger weight streams per layer make the
fused talker step (K3) faster. ``premerge`` builds its per-layer blocks:
wA (L, H, QKVD + 2I) int8 = [qkv | gate|up] with scales sA, wB (L, QD + I,
H) int8 = [o ; down] with scales sB, and vec (L, 1, W) f32 = [sA | sB |
input_ln | post_ln | q_norm | k_norm]. As in the tool, the merged blocks
ride in the layer dict beside the unmerged tensors, under the keys m_wA,
m_sA, m_wB, m_sB and m_vec (``with_merged``). Two variants, each a
dispatcher with its own launch counter:

- ``talker_decode_step_merged``: the products read wA and wB with the
  scales sA and sB; the norms come from the layer dict;
- ``talker_decode_step_mergedvec``: wA and wB with every scale and norm
  from the one vec block.

The math is K3's, op for op: the plain version slices the merged blocks
into K3's four products and runs ``talker_step_plain``, so on the card
K7 is bit-equal to K3 on the same weights (the JAX tool asserts the
same codes).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from qwen3_tts_tpu_torch.ops.kernels.talker_step import (
    scatter_rows, talker_step_cuda, talker_step_plain)
from qwen3_tts_tpu_torch.ops.quant import QTensor

NORMS = ("input_ln", "post_ln", "q_norm", "k_norm")


def premerge(layers: Dict) -> Dict[str, torch.Tensor]:
    """The merged per-layer blocks of an ops/quant.quantize_talker layer
    dict, laid out as the JAX tool's ``premerge``: wA, sA, wB, sB, vec."""
    qkv, o = layers["qkv_proj"], layers["o_proj"]
    gu, d = layers["gateup_proj"], layers["down_proj"]
    out = {"wA": torch.cat([qkv.q, gu.q], dim=2),
           "sA": torch.cat([qkv.scale, gu.scale], dim=-1),
           "wB": torch.cat([o.q, d.q], dim=1),
           "sB": torch.cat([o.scale, d.scale], dim=-1)}
    L = qkv.q.shape[0]

    def v2(a):
        return a.float().reshape(L, 1, -1)

    out["vec"] = torch.cat([v2(out["sA"]), v2(out["sB"])]
                           + [v2(layers[n]) for n in NORMS], dim=-1)
    return out


def with_merged(layers: Dict) -> Dict:
    """The layer dict with the premerged blocks added as m_wA, m_sA, m_wB,
    m_sB and m_vec."""
    return {**layers, **{f"m_{k}": v for k, v in premerge(layers).items()}}


def merged_views(layers: Dict, vec_merged: bool) -> Dict:
    """K3's layer dict as views of the merged blocks: qkv = wA[:, :, :QKVD],
    gate|up = wA[:, :, QKVD:], o = wB[:, :QD], down = wB[:, QD:], with
    their scales and the norms from sA / sB and the layer dict, or all
    from vec."""
    H, NQKV = layers["qkv_proj"].q.shape[1:]
    QD = layers["o_proj"].q.shape[1]
    Dh = layers["q_norm"].shape[-1]
    wA, wB = layers["m_wA"], layers["m_wB"]
    if vec_merged:
        sA, sB, *norms = torch.split(
            layers["m_vec"][:, 0], [wA.shape[2], 2 * H, H, H, Dh, Dh],
            dim=-1)
    else:
        sA, sB = layers["m_sA"], layers["m_sB"]
        norms = [layers[n] for n in NORMS]
    return {"qkv_proj": QTensor(wA[:, :, :NQKV], sA[:, :NQKV]),
            "gateup_proj": QTensor(wA[:, :, NQKV:], sA[:, NQKV:]),
            "o_proj": QTensor(wB[:, :QD], sB[:, :H]),
            "down_proj": QTensor(wB[:, QD:], sB[:, H:]),
            **dict(zip(NORMS, norms))}


def talker_merged_plain(layers: Dict, x: torch.Tensor, pos: torch.Tensor,
                        kv: torch.Tensor, rope_cos: torch.Tensor,
                        rope_sin: torch.Tensor, eps: float,
                        vec_merged: bool):
    """The kernel's plain PyTorch version: K3's over the merged views.
    Returns (h (B, H) in x's dtype, fresh rows (L, 2, B, nKV, Dh) f32)."""
    return talker_step_plain(merged_views(layers, vec_merged), x, pos, kv,
                             rope_cos, rope_sin, eps)


def talker_merged_cuda(layers: Dict, x: torch.Tensor, pos: torch.Tensor,
                       kv: torch.Tensor, rope_cos: torch.Tensor,
                       rope_sin: torch.Tensor, eps: float, vec_merged: bool):
    """Launch K7: the step kernel over the merged views (each a strided
    view of wA, wB and sA / sB or vec); same contract as
    talker_merged_plain."""
    return talker_step_cuda(merged_views(layers, vec_merged), x, pos, kv,
                            rope_cos, rope_sin, eps)


def _step(vec_merged: bool, layers: Dict, x: torch.Tensor,
          pos: torch.Tensor, kv: torch.Tensor, rope_cos: torch.Tensor,
          rope_sin: torch.Tensor, eps: float):
    if x.device.type == "cpu":
        h, rows = talker_merged_plain(layers, x, pos, kv, rope_cos, rope_sin,
                                      eps, vec_merged)
    elif x.is_cuda:
        h, rows = talker_merged_cuda(layers, x, pos, kv, rope_cos, rope_sin,
                                     eps, vec_merged)
        (talker_decode_step_mergedvec if vec_merged
         else talker_decode_step_merged).launches += 1
    else:
        raise ValueError(f"talker_step_merged: unsupported device "
                         f"{x.device}")
    return h, scatter_rows(kv, pos, rows)


def talker_decode_step_merged(layers: Dict, x: torch.Tensor,
                              pos: torch.Tensor, kv: torch.Tensor,
                              rope_cos: torch.Tensor, rope_sin: torch.Tensor,
                              *, eps: float) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """One talker decode step over the merged weight streams (scales from
    sA / sB, norms from the layer dict): K7 on a CUDA tensor, its plain
    version on a CPU tensor. The contract of
    talker_step.talker_decode_step_fused, whose place it can take."""
    return _step(False, layers, x, pos, kv, rope_cos, rope_sin, eps)


def talker_decode_step_mergedvec(layers: Dict, x: torch.Tensor,
                                 pos: torch.Tensor, kv: torch.Tensor,
                                 rope_cos: torch.Tensor,
                                 rope_sin: torch.Tensor, *,
                                 eps: float) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """talker_decode_step_merged with every scale and norm weight read
    from the merged vec block."""
    return _step(True, layers, x, pos, kv, rope_cos, rope_sin, eps)


talker_decode_step_merged.launches = 0
talker_decode_step_mergedvec.launches = 0

