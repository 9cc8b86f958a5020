"""Build and load the port's hand-written CUDA kernels.

Every source under ``qwen3_tts_tpu_torch/csrc/`` is compiled by its own
``nvcc`` (all started together), and the objects are linked into ONE
shared library with a plain C interface, at first use, into
``build/qwen3_tts_tpu_torch/`` at the repository root. The file name
carries a hash of the sources and the flags, so an edited source builds
anew. The library is loaded with ``ctypes``: every entry point takes
pointers (``c_void_p``), ints (``c_int``; floats travel as their f32
bit pattern, see ``f32_bits``) and longs (``c_long``, element strides),
launches on the stream it is given, allocates nothing, and returns
``cudaGetLastError()``.

No PyTorch header is compiled in, which keeps the build to seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
from pathlib import Path

from qwen3_tts_tpu_torch.utils import profiling

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "qwen3_tts_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH or /usr/local/cuda/bin)")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libq3tts_{h.hexdigest()[:16]}.so"


def _run(procs):
    """Wait for every (cmd, Popen); raise with the first failure's
    output."""
    failed = None
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode, out, err)
    if failed:
        cmd, rc, out, err = failed
        raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}\n"
                           f"{err}")


def _compile(path: Path) -> None:
    """One nvcc per source, all at once, then one link into ``path``."""
    nvcc = _nvcc()
    work = BUILD_DIR / f"obj.{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    try:
        procs, objs = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = work / f"{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
            objs.append(str(obj))
        _run(procs)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *objs]
        _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True))])
        os.replace(tmp, path)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; raises on failure.
    Recorded as the span ``build`` (its ``nvcc`` attribute says whether
    this process compiled)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        with profiling.span("build") as sp:
            path = library_path()
            sp.set(nvcc=not path.exists())
            if sp.attrs["nvcc"]:
                _compile(path)
            lib = ctypes.CDLL(str(path))
        lib.q3_error_string.argtypes = [ctypes.c_int]
        lib.q3_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def function(name: str, sig: str):
    """Entry point ``name`` with argument kinds ``sig`` ('p' pointer,
    'i' int, 'l' long); the returned callable raises if the CUDA status is
    not 0."""
    lib = load()
    fn = getattr(lib, name)
    kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int, "l": ctypes.c_long}
    fn.argtypes = [kinds[c] for c in sig]
    fn.restype = ctypes.c_int

    def call(*args):
        if len(args) != len(sig):
            raise TypeError(f"{name} takes {len(sig)} arguments, "
                            f"got {len(args)}")
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA error {err} "
                               f"({lib.q3_error_string(err).decode()})")

    return call


def f32_bits(x: float) -> int:
    """The f32 bit pattern of ``x`` as a signed int (the C side reads it
    back with __int_as_float), so float arguments cross ctypes exactly."""
    return struct.unpack("<i", struct.pack("<f", float(x)))[0]


def stream() -> int:
    import torch
    return torch.cuda.current_stream().cuda_stream
