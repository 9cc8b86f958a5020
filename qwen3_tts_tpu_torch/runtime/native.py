"""ctypes binding of libttsrt (native/ttsrt.cc), the host runtime: the
Unix-socket accept loop with exact framing that serve/daemon.py runs on,
npy read and write, WAV write, f32 -> int16, and zero-copy safetensors
access. Twin of qwen3_tts_tpu/runtime/native.py.

The library is compiled from the repository's ``native/ttsrt.cc`` by
``g++`` with the flags of ``native/Makefile``, at first use, into
``build/qwen3_tts_tpu_torch/libttsrt_<hash>.so``; the hash covers the
sources and the flags, so an edited source builds anew, and nothing is
written under ``native/``. Every entry point keeps the JAX package's
pure-Python fallback for when the library cannot be built;
``available()`` says which path is active.
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
from typing import Optional

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
BUILD_DIR = (Path(__file__).resolve().parents[2] / "build"
             / "qwen3_tts_tpu_torch")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")

_lock = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_LIB_TRIED = False


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in ("ttsrt.cc", "npyio.h"):
        h.update(name.encode())
        h.update((NATIVE_DIR / name).read_bytes())
    return BUILD_DIR / f"libttsrt_{h.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    """g++ on native/ttsrt.cc into a temporary file beside ``path``, then
    an atomic rename (concurrent builds each write their own file)."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp),
                        str(NATIVE_DIR / "ttsrt.cc")],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, path)
    finally:
        if tmp.exists():
            tmp.unlink()


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_TRIED
    with _lock:
        if _LIB_TRIED:
            return _LIB
        _LIB_TRIED = True
        try:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
        except (OSError, subprocess.SubprocessError):
            return None
        _declare(lib)
        _LIB = lib
        return lib


def _declare(lib: ctypes.CDLL) -> None:
    c_p, c_i, c_i64, c_s = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                            ctypes.c_char_p)
    sigs = {
        "ttsrt_st_open": (c_p, [c_s]),
        "ttsrt_st_count": (c_i, [c_p]),
        "ttsrt_st_name": (c_s, [c_p, c_i]),
        "ttsrt_st_info": (c_i, [c_p, c_s, c_s, ctypes.POINTER(c_i64),
                                ctypes.POINTER(c_i64)]),
        "ttsrt_st_data": (c_p, [c_p, c_s]),
        "ttsrt_st_close": (None, [c_p]),
        "ttsrt_npy_read": (c_p, [c_s]),
        "ttsrt_npy_ndim": (c_i, [c_p]),
        "ttsrt_npy_dim": (c_i64, [c_p, c_i]),
        "ttsrt_npy_dtype": (c_s, [c_p]),
        "ttsrt_npy_data": (c_p, [c_p]),
        "ttsrt_npy_free": (None, [c_p]),
        "ttsrt_npy_write": (c_i, [c_s, c_p, ctypes.POINTER(c_i64), c_i,
                                  c_s]),
        "ttsrt_wav_write": (c_i, [c_s, c_p, c_i64, c_i]),
        "ttsrt_f32_to_i16": (None, [c_p, c_p, c_i64]),
        # int64 caps: without argtypes ctypes would pass 32-bit ints
        "ttsrt_serve_unix": (c_i, [c_s, _HANDLER_T, c_i64, c_i64]),
        "ttsrt_serve_stop": (None, []),
        "ttsrt_serve_reset": (None, []),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args


def available() -> bool:
    return _load() is not None


# ---------------------------------------------------------------------------
# safetensors (zero-copy)
# ---------------------------------------------------------------------------

_ST_DTYPES = {
    "F32": np.float32, "F16": np.float16, "BF16": None,  # bf16 upcast
    "I64": np.int64, "I32": np.int32, "F64": np.float64, "U8": np.uint8,
}


def _bf16_to_f32(raw_u16: np.ndarray) -> np.ndarray:
    out = np.zeros(raw_u16.shape, np.uint32)
    out |= raw_u16.astype(np.uint32) << 16
    return out.view(np.float32)


class _PySafetensors:
    """Pure-Python mmap safetensors parser (the fallback); reads BF16
    (upcast to float32)."""

    _DTYPES = {
        "F64": np.float64, "F32": np.float32, "F16": np.float16,
        "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
        "U8": np.uint8, "U16": np.uint16, "U32": np.uint32, "U64": np.uint64,
        "BOOL": np.bool_,
    }

    def __init__(self, path: str):
        import json
        self._mm = np.memmap(path, np.uint8, mode="r")
        hlen = int(np.frombuffer(self._mm[:8], np.uint64)[0])
        header = json.loads(bytes(self._mm[8:8 + hlen]).decode("utf-8"))
        header.pop("__metadata__", None)
        self._base = 8 + hlen
        self._meta = header

    def keys(self):
        return list(self._meta.keys())

    def tensor(self, name: str) -> np.ndarray:
        meta = self._meta[name]
        dt, shape = meta["dtype"], tuple(meta["shape"])
        beg, end = meta["data_offsets"]
        buf = self._mm[self._base + beg:self._base + end]
        if dt == "BF16":
            return _bf16_to_f32(np.frombuffer(buf, np.uint16).reshape(shape))
        npdt = self._DTYPES.get(dt)
        if npdt is None:
            raise ValueError(f"unsupported safetensors dtype {dt}")
        return np.frombuffer(buf, npdt).reshape(shape)


class SafetensorsFile:
    """mmap-backed zero-copy safetensors reader (native), with the
    pure-Python mmap fallback. Both paths upcast BF16 to f32."""

    def __init__(self, path: str):
        self.path = path
        self._h = None
        self._fallback = None
        lib = _load()
        if lib is not None:
            self._h = lib.ttsrt_st_open(path.encode())
        if not self._h:
            self._fallback = _PySafetensors(path)

    def keys(self):
        if self._fallback is not None:
            return self._fallback.keys()
        n = _LIB.ttsrt_st_count(self._h)
        return [_LIB.ttsrt_st_name(self._h, i).decode() for i in range(n)]

    def tensor(self, name: str) -> np.ndarray:
        """A numpy view (zero-copy on the native path; bf16 upcast)."""
        if self._fallback is not None:
            return self._fallback.tensor(name)
        dtype_buf = ctypes.create_string_buffer(8)
        shape = (ctypes.c_int64 * 8)()
        nbytes = ctypes.c_int64()
        ndim = _LIB.ttsrt_st_info(self._h, name.encode(), dtype_buf, shape,
                                  ctypes.byref(nbytes))
        if ndim < 0:
            raise KeyError(name)
        ptr = _LIB.ttsrt_st_data(self._h, name.encode())
        shp = tuple(shape[i] for i in range(ndim))
        dt = dtype_buf.value.decode()
        buf = (ctypes.c_char * nbytes.value).from_address(ptr)
        if dt == "BF16":
            return _bf16_to_f32(np.frombuffer(buf, np.uint16).reshape(shp))
        npdt = _ST_DTYPES.get(dt)
        if npdt is None:
            raise ValueError(f"unsupported dtype {dt}")
        return np.frombuffer(buf, npdt).reshape(shp)

    def close(self):
        if self._h and _LIB is not None:
            _LIB.ttsrt_st_close(self._h)
            self._h = None


def read_safetensors(path: str) -> dict:
    """Every tensor of a .safetensors file as numpy arrays (BF16 upcast
    to f32), copied out of the mapping before it is closed."""
    f = SafetensorsFile(path)
    try:
        return {k: np.array(f.tensor(k), copy=True) for k in f.keys()}
    finally:
        f.close()


# ---------------------------------------------------------------------------
# npy / WAV helpers
# ---------------------------------------------------------------------------

def npy_read(path: str) -> np.ndarray:
    lib = _load()
    if lib is None:
        return np.load(path)
    h = lib.ttsrt_npy_read(path.encode())
    if not h:
        raise IOError(f"npy read failed: {path}")
    try:
        ndim = lib.ttsrt_npy_ndim(h)
        shape = tuple(lib.ttsrt_npy_dim(h, i) for i in range(ndim))
        np_dt = np.dtype(lib.ttsrt_npy_dtype(h).decode())
        n = int(np.prod(shape)) if shape else 1
        buf = (ctypes.c_char * (n * np_dt.itemsize)).from_address(
            lib.ttsrt_npy_data(h))
        return np.frombuffer(buf, np_dt).reshape(shape).copy()
    finally:
        lib.ttsrt_npy_free(h)


def npy_write(path: str, arr: np.ndarray) -> None:
    lib = _load()
    if lib is None:
        np.save(path, arr)
        return
    arr = np.ascontiguousarray(arr)
    shape = (ctypes.c_int64 * arr.ndim)(*arr.shape)
    rc = lib.ttsrt_npy_write(path.encode(), arr.ctypes.data, shape,
                             arr.ndim, arr.dtype.str.encode())
    if rc != 0:
        raise IOError(f"npy write failed: {path}")


def wav_write(path: str, audio_int16: np.ndarray, sample_rate: int) -> None:
    lib = _load()
    if lib is None:
        from qwen3_tts_tpu_torch.io.wav import write_wav
        write_wav(path, audio_int16, sample_rate)
        return
    a = np.ascontiguousarray(audio_int16, np.int16)
    rc = lib.ttsrt_wav_write(path.encode(), a.ctypes.data, len(a),
                             sample_rate)
    if rc != 0:
        raise IOError(f"wav write failed: {path}")


def f32_to_i16(audio: np.ndarray) -> np.ndarray:
    lib = _load()
    a = np.ascontiguousarray(audio, np.float32)
    if lib is None:
        return np.clip(a * 32767, -32768, 32767).astype(np.int16)
    out = np.empty(len(a), np.int16)
    lib.ttsrt_f32_to_i16(a.ctypes.data, out.ctypes.data, len(a))
    return out


# ---------------------------------------------------------------------------
# daemon serve loop
# ---------------------------------------------------------------------------

_HANDLER_T = ctypes.CFUNCTYPE(ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
                              ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
                              ctypes.c_int64, ctypes.c_int)

_TTSRT_HANDLED = -2  # the handler wrote its frames to the fd itself


def _write_all(fd: int, data: bytes) -> None:
    view = memoryview(data)
    while view:
        n = os.write(fd, view)
        view = view[n:]


def serve_unix(socket_path: str, handler, max_req: int = 1 << 20,
               resp_cap: int = 1 << 26) -> int:
    """Run the native accept/framing loop. ``handler(request_bytes,
    send_frame)`` either returns the response bytes (one framed response)
    or calls ``send_frame(payload)`` once or more, each writing ``[u32
    len][payload]`` straight to the connection, and returns None. Blocks
    until ``serve_stop()``. The stop flag is process-global and sticky:
    call ``serve_reset()`` before entering if a previous ``serve_stop()``
    may have fired (the loop does not clear it, so a stop racing the
    entry is honoured). Needs the library (serve/daemon.py falls back to
    a Python loop without it)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("libttsrt not available")

    @_HANDLER_T
    def c_handler(req_ptr, req_len, resp_ptr, cap, fd):
        try:
            req = ctypes.string_at(req_ptr, req_len)

            def send_frame(payload: bytes) -> None:
                _write_all(fd, struct.pack("<I", len(payload)) + payload)

            resp = handler(req, send_frame)
            if resp is None:
                return _TTSRT_HANDLED
            if len(resp) > cap:
                return -1
            ctypes.memmove(resp_ptr, resp, len(resp))
            return len(resp)
        except Exception:
            return -1

    return lib.ttsrt_serve_unix(socket_path.encode(), c_handler,
                                max_req, resp_cap)


def serve_stop() -> None:
    lib = _load()
    if lib is not None:
        lib.ttsrt_serve_stop()


def serve_reset() -> None:
    """Re-arm the process-global native stop flag before serve_unix; a
    call of its own so that a stop() racing the entry stays sticky."""
    lib = _load()
    if lib is not None:
        lib.ttsrt_serve_reset()
