"""Weight-only int8 quantization for the talker / code-predictor matmuls.
Twin of qwen3_tts_tpu/ops/quant.py.

Symmetric per-output-channel int8 weights: decode streams half the bf16
bytes, and the int8 -> bf16 conversion happens inside the kernels
(ops/kernels/qmatmul.py, talker_step.py, cp_decode.py), so bf16 copies of
the weights never exist in device memory. The vocoder is never quantized.
"""

from __future__ import annotations

from typing import Union

import torch

from qwen3_tts_tpu_torch.ops.kernels.qmatmul import qmatmul, qmatmul_group


class QTensor:
    """Symmetric per-out-channel int8 weight: w ~= q * scale.

    q: int8 (..., K, N); scale: f32 (..., N). Leading dims are layer or
    group stacks; indexing them returns views."""

    __slots__ = ("q", "scale")

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        self.q = q
        self.scale = scale

    def __getitem__(self, idx) -> "QTensor":
        return QTensor(self.q[idx], self.scale[idx])

    def __repr__(self):
        return (f"QTensor(int8 {tuple(self.q.shape)}, "
                f"scale {tuple(self.scale.shape)})")


MaybeQuant = Union[torch.Tensor, QTensor]


def quantize_int8(w: torch.Tensor) -> QTensor:
    """Quantize (..., K, N) weights to int8 with per-(..., N) scales."""
    wf = w.float()
    amax = wf.abs().amax(dim=-2)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / scale[..., None, :]), -127, 127)
    return QTensor(q.to(torch.int8), scale.float())


def dequantize(w: QTensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (w.q.float() * w.scale[..., None, :]).to(dtype)


def matmul(x: torch.Tensor, w: MaybeQuant) -> torch.Tensor:
    """x (..., K) @ w (K, N), always accumulated and returned in f32.

    A QTensor goes to K1 (ops/kernels/qmatmul.py) for any number of
    leading dims: on the card the kernel, on the CPU its plain version.
    No fallback: a kernel failure raises."""
    if not isinstance(w, QTensor):
        return x.float() @ w.float()
    lead = x.shape[:-1]
    out = qmatmul(x.reshape(-1, x.shape[-1]), w.q, w.scale)
    return out.reshape(*lead, w.q.shape[-1])


def matmul_group(x: torch.Tensor, ws) -> list:
    """[matmul(x, w) for w in ws], the same bits: int8 weights that share
    x go to K1 as one group (ops/kernels/qmatmul.qmatmul_group: one launch
    for up to three of them at decode rows); any dense weight makes it
    one product a weight."""
    if not all(isinstance(w, QTensor) for w in ws):
        return [matmul(x, w) for w in ws]
    lead = x.shape[:-1]
    outs = qmatmul_group(x.reshape(-1, x.shape[-1]),
                         [(w.q, w.scale) for w in ws])
    return [o.reshape(*lead, o.shape[-1]) for o in outs]


def quantize_layer_stack(layers: dict, fuse: bool = False) -> dict:
    """Quantize the seven projection matrices of a stacked layer dict;
    norms stay dense. ``fuse=True`` stores the concatenated q|k|v and
    gate|up weights instead ("qkv_proj", "gateup_proj"): the projections
    that share an input become one product (per-channel scales
    concatenate losslessly along the output axis)."""
    out = dict(layers)
    solo = (("o_proj", "down_proj") if fuse else
            ("q_proj", "k_proj", "v_proj", "o_proj",
             "gate_proj", "up_proj", "down_proj"))
    for name in solo:
        out[name] = quantize_int8(layers[name])
    if fuse:
        out["qkv_proj"] = quantize_int8(torch.cat(
            [layers["q_proj"], layers["k_proj"], layers["v_proj"]], dim=-1))
        out["gateup_proj"] = quantize_int8(torch.cat(
            [layers["gate_proj"], layers["up_proj"]], dim=-1))
        for name in ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj"):
            del out[name]
    return out


def attach_layer_list(component: dict) -> dict:
    """Attach per-layer views of the stacked layer dict ("layers_list"),
    which the unrolled prefill walks. Indexing a stacked tensor is a view
    in PyTorch, so this copies nothing."""
    if "layers_list" in component:
        return component
    out = dict(component)
    layers = component["layers"]
    L = layers["input_ln"].shape[0]
    out["layers_list"] = [{k: v[l] for k, v in layers.items()}
                          for l in range(L)]
    return out


def quantize_talker(params: dict) -> dict:
    out = dict(params)
    out.pop("layers_list", None)
    out["layers"] = quantize_layer_stack(params["layers"], fuse=True)
    out["codec_head"] = quantize_int8(params["codec_head"])
    return attach_layer_list(out)


def quantize_code_predictor(params: dict) -> dict:
    out = dict(params)
    out.pop("layers_list", None)
    out["layers"] = quantize_layer_stack(params["layers"])
    out["lm_heads"] = quantize_int8(params["lm_heads"])
    return attach_layer_list(out)
