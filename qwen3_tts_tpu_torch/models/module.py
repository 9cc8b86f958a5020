"""nn.Module holders for the JAX-layout weight trees.

The model math is plain functions on a nested dict of tensors, as in the
JAX package; a model module holds that dict as buffers under the JAX
names and in the JAX (in, out) layouts, so ``.to(device)`` and
``state_dict()`` work, and ``weights()`` hands the dict back."""

from __future__ import annotations

import torch
from torch import nn

from qwen3_tts_tpu_torch.ops.quant import QTensor, attach_layer_list


class _QWeight(nn.Module):
    def __init__(self, w: QTensor):
        super().__init__()
        self.register_buffer("q", w.q)
        self.register_buffer("scale", w.scale)

    def weights(self) -> QTensor:
        return QTensor(self.q, self.scale)


class WeightTree(nn.Module):
    """A nested weight dict as child modules and buffers. Derived views
    (``layers_list``) are not stored; ``weights()`` rebuilds them."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if k == "layers_list":
                continue
            if isinstance(v, dict):
                self.add_module(k, WeightTree(v))
            elif isinstance(v, QTensor):
                self.add_module(k, _QWeight(v))
            elif isinstance(v, torch.Tensor):
                self.register_buffer(k, v)
            else:
                raise TypeError(f"weight {k!r}: unsupported {type(v)}")

    def weights(self) -> dict:
        out = {k: m.weights() for k, m in self.named_children()}
        out.update(self.named_buffers(recurse=False))
        if any(isinstance(v, QTensor)
               for v in out.get("layers", {}).values()):
            out = attach_layer_list(out)
        return out
