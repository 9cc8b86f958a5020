"""The port's binding of the native runtime (qwen3_tts_tpu_torch.runtime
.native) against the JAX package's (qwen3_tts_tpu.runtime.native): the
same bytes for npy, WAV and f32 -> int16, the same safetensors reads,
and a serve_unix round trip. The port builds its own copy of
native/ttsrt.cc under build/qwen3_tts_tpu_torch/ and writes nothing
under native/."""

import os
import socket
import struct
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from qwen3_tts_tpu.runtime import native as jnative
from qwen3_tts_tpu_torch.runtime import native as tnative

ROOT = Path(__file__).resolve().parents[1]


def test_library_builds_under_build_dir(tmp_path, monkeypatch):
    """A fresh build lands in the build dir it is given (by default
    build/qwen3_tts_tpu_torch/ at the root), named by a hash of the
    sources, and leaves native/ as it was."""
    assert tnative.library_path().parent == (
        ROOT / "build" / "qwen3_tts_tpu_torch")
    assert tnative.available()
    assert Path(tnative._LIB._name) == tnative.library_path()
    before = sorted((p.name, p.stat().st_mtime_ns)
                    for p in (ROOT / "native").iterdir())
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "b")
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "_LIB_TRIED", False)
    assert tnative.available()
    built = list((tmp_path / "b").iterdir())
    assert [p.name for p in built] == [tnative.library_path().name]
    assert tnative.library_path().name.startswith("libttsrt_")
    after = sorted((p.name, p.stat().st_mtime_ns)
                   for p in (ROOT / "native").iterdir())
    assert after == before


@pytest.mark.parametrize("dtype", ["<f4", "<i8", "<f8", "<i4"])
def test_npy_bytes_match_jax(tmp_path, dtype):
    a = (np.arange(24).reshape(2, 3, 4) * 1.5 - 7).astype(dtype)
    tnative.npy_write(str(tmp_path / "t.npy"), a)
    jnative.npy_write(str(tmp_path / "j.npy"), a)
    assert ((tmp_path / "t.npy").read_bytes()
            == (tmp_path / "j.npy").read_bytes())
    back = tnative.npy_read(str(tmp_path / "j.npy"))
    want = jnative.npy_read(str(tmp_path / "j.npy"))
    assert back.dtype == want.dtype     # the native reader reads f8 as f4
    np.testing.assert_array_equal(back, want)
    np.testing.assert_array_equal(back, a.astype(back.dtype))
    np.testing.assert_array_equal(np.load(tmp_path / "t.npy"), a)


def test_wav_and_int16_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    f = np.concatenate([rng.uniform(-1.2, 1.2, 999).astype(np.float32),
                        np.float32([0.5, -1.0, 1.0, 2.0, -2.0])])
    i16 = tnative.f32_to_i16(f)
    np.testing.assert_array_equal(i16, jnative.f32_to_i16(f))
    assert i16[-1] == -32768 and i16[-2] == 32767
    tnative.wav_write(str(tmp_path / "t.wav"), i16, 24000)
    jnative.wav_write(str(tmp_path / "j.wav"), i16, 24000)
    assert ((tmp_path / "t.wav").read_bytes()
            == (tmp_path / "j.wav").read_bytes())


def test_safetensors_reads_match_jax(tmp_path):
    """F32, I64 and BF16 (upcast to f32) tensors, native and fallback."""
    import json
    tensors = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
               "b": np.arange(4, dtype=np.int64)}
    bf16 = np.array([0x3F80, 0xC000, 0x3E80], np.uint16)   # 1, -2, 0.25
    header, blobs, off = {}, [], 0
    for name, arr, dt in (("a", tensors["a"], "F32"),
                          ("b", tensors["b"], "I64"),
                          ("c", bf16, "BF16")):
        raw = arr.tobytes()
        header[name] = {"dtype": dt, "shape": list(arr.shape),
                        "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    h = json.dumps(header).encode()
    path = tmp_path / "w.safetensors"
    path.write_bytes(struct.pack("<Q", len(h)) + h + b"".join(blobs))
    got = tnative.read_safetensors(str(path))
    want = jnative.read_safetensors(str(path))
    assert sorted(got) == sorted(want) == ["a", "b", "c"]
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["c"], np.float32([1.0, -2.0, 0.25]))
    py = tnative._PySafetensors(str(path))
    for k in got:
        np.testing.assert_array_equal(py.tensor(k), got[k])


def _frame(c):
    raw = b""
    while len(raw) < 4:
        raw += c.recv(4 - len(raw))
    n = struct.unpack("<I", raw)[0]
    data = b""
    while len(data) < n:
        data += c.recv(n - len(data))
    return data


def _connect(path, deadline):
    """A client of the loop at ``path``. The loop binds (the path
    appears) before it listens, so a connect in between is refused:
    retry that until ``deadline``."""
    while True:
        c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            c.connect(path)
            return c
        except ConnectionRefusedError:
            c.close()
            if time.time() > deadline:
                raise
            time.sleep(0.05)


def test_serve_unix_roundtrip(tmp_path):
    """A blob reply, then a handler that writes two frames itself."""
    sock_path = str(tmp_path / "d.sock")

    def handler(req: bytes, send_frame):
        if req == b"stream":
            send_frame(b"frame0")
            send_frame(b"frame1")
            return None
        return b"echo:" + req

    tnative.serve_reset()
    t = threading.Thread(target=tnative.serve_unix,
                         args=(sock_path, handler), daemon=True)
    t.start()
    deadline = time.time() + 5
    while not os.path.exists(sock_path) and time.time() < deadline:
        time.sleep(0.05)
    try:
        for msg, want in ((b"hello", [b"echo:hello"]),
                          (b"stream", [b"frame0", b"frame1"])):
            c = _connect(sock_path, deadline)
            c.sendall(struct.pack("<I", len(msg)) + msg)
            assert [_frame(c) for _ in want] == want
            c.close()
    finally:
        tnative.serve_stop()
        t.join(timeout=5)
    assert not t.is_alive()
    assert not os.path.exists(sock_path)
