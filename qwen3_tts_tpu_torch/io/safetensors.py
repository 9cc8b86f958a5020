"""A safetensors reader for the port, in pure Python: the header is
JSON, each tensor a byte range after it. The port's copy of the
pure-Python reader of qwen3_tts_tpu/runtime/native.py, needing neither
the ``safetensors`` package nor a native library.

Tensors come back as torch tensors in their stored dtype: BF16 is the
file's bits viewed as ``torch.bfloat16``, never upcast (a 0.6B talker
in bf16 is 1.8 GB; the loaders of io/weights.py cast where they must).
The dtypes the JAX package's reader refuses are refused here too."""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Tuple

import torch

_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8, "U16": torch.uint16, "U32": torch.uint32,
    "U64": torch.uint64,
    "BOOL": torch.bool,
}


def _header(f) -> Tuple[dict, int]:
    """(tensor name -> entry, byte offset of the data) of an open file."""
    (n,) = struct.unpack("<Q", f.read(8))
    hdr = json.loads(f.read(n).decode("utf-8"))
    hdr.pop("__metadata__", None)
    return hdr, 8 + n


def list_safetensors_keys(path: str) -> Dict[str, tuple]:
    """Only the JSON header: tensor name -> (dtype string, shape tuple).
    No weight bytes are read."""
    with open(path, "rb") as f:
        hdr, _ = _header(f)
    return {k: (v["dtype"], tuple(v["shape"])) for k, v in hdr.items()}


def read_safetensors(path: str, device="cpu") -> Dict[str, torch.Tensor]:
    """Every tensor of a .safetensors file, each read into its own host
    buffer in file order, then moved to ``device``. Raises ValueError for
    a dtype outside the JAX package's reader's set and for a byte range
    that does not match the tensor's shape or lies past the file."""
    out = {}
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        hdr, base = _header(f)
        for name, meta in sorted(hdr.items(),
                                 key=lambda kv: kv[1]["data_offsets"][0]):
            dtype = _DTYPES.get(meta["dtype"])
            if dtype is None:
                raise ValueError(f"{path}: tensor {name!r} has unsupported "
                                 f"safetensors dtype {meta['dtype']}")
            shape = tuple(meta["shape"])
            beg, end = meta["data_offsets"]
            numel = 1
            for d in shape:
                numel *= d
            want = numel * torch.empty((), dtype=dtype).element_size()
            if end - beg != want or base + end > size:
                raise ValueError(f"{path}: tensor {name!r} has byte range "
                                 f"[{beg}, {end}) for {want} bytes")
            buf = torch.empty(want, dtype=torch.uint8)
            f.seek(base + beg)
            if want and f.readinto(buf.numpy()) != want:
                raise ValueError(f"{path}: tensor {name!r} is truncated")
            out[name] = buf.view(dtype).reshape(shape).to(device)
    return out
