"""The port's batched daemon over a multi-rank dp x tp mesh (serve/
lockstep.py: a rank-0 front end that broadcasts every step's admissions)
on the CPU, at tiny geometry in f32, each daemon a subprocess that starts
its own ranks over gloo.

- dp 2 x tp 2 over four ranks, the twin of tests/test_daemon.py::
  test_daemon_main_mesh_flags: it reports the mesh, serves a blob and a
  stream (its frames within +-1 LSB of the blob, as any stream), and
  drains on SIGTERM with exit 0 and no socket left.
- dp 2 x tp 1: blob, stream, cloned and prioritised requests, sent
  together, equal an in-process no-mesh ContinuousBatcher's bit for bit
  (dp issues no collective on the data path); a client that vanishes
  mid-decode is cancelled on both ranks at the same chunk boundary, and
  the next request is served; at the stop every slot is free on both
  ranks, which stepped alike.
- The broadcast message, round-tripped through the front end's encoder
  without ranks.

Both daemons start together (module fixture), so their start-up
overlaps.
"""

import ast
import json
import os
import pickle
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from qwen3_tts_tpu_torch import config as pconfig
from qwen3_tts_tpu_torch.engine.engine import TTSEngine
from qwen3_tts_tpu_torch.serve import daemon as tdaemon
from qwen3_tts_tpu_torch.serve import lockstep
from qwen3_tts_tpu_torch.serve.batching import ContinuousBatcher

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TINY = pconfig.tiny_tts_config(max_tokens=32)   # the daemon's --tiny

# (text, seed, kind) of the dp 2 daemon's concurrent requests
DP_REQUESTS = (("dp daemon blob", 1, "blob"),
               ("a streamed request", 2, "stream"),
               ("cloned voice", 3, "cloned"),
               ("urgent words", 4, "priority"))
VANISH = ("this client goes away while its request decodes", 5)
# every other request's token cap (the vanishing one runs to the budget)
CAP = 12
AFTER = ("served after the vanished client", 6)


def _start(tmp: Path, name: str, flags) -> tuple:
    sock = str(tmp / f"{name}.sock")
    # the byte tokenizer, which the daemon falls back to here anyway,
    # without the transformers import each rank would try first
    env = dict(os.environ, OMP_NUM_THREADS="1", QWEN3_TTS_TOKENIZER="byte")
    env.pop("PYTHONPATH", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "qwen3_tts_tpu_torch.serve.daemon", "--tiny",
         "--device", "cpu", "--dtype", "float32", "--decode_chunk", "4",
         "--python_loop", "--socket", sock, *flags],
        cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    return proc, sock


def _wait(proc, sock: str) -> None:
    deadline = time.time() + 120
    while not os.path.exists(sock):
        assert proc.poll() is None, proc.stdout.read().decode(
            errors="replace")
        assert time.time() < deadline, "the socket never appeared"
        time.sleep(0.1)


def _stop(proc) -> str:
    proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=90)
    return out.decode(errors="replace")


def _prompt_dir(root: Path) -> str:
    d = root / "voice"
    d.mkdir()
    np.save(d / "ref_codec_tokens.npy", np.random.default_rng(9).integers(
        0, 2048, (12, 16)).astype(np.int64))
    (d / "ref_text.txt").write_text("ref words")
    return str(d)


def _vanish(sock: str) -> None:
    """A streaming client that sends its request and goes away: the
    daemon finds it gone at its first frame and withdraws the request."""
    text, seed = VANISH
    msg = json.dumps({"text": text, "language": "english", "seed": seed,
                      "stream": True}).encode()
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    c.connect(sock)
    c.sendall(struct.pack("<I", len(msg)) + msg)
    c.close()


def _dp_requests(sock: str, prompt_dir: str) -> dict:
    out, errors = {}, []

    def call(i, text, seed, kind):
        frames = []
        try:
            hdr, audio = tdaemon.DaemonClient(sock).synthesize(
                text, language="english", seed=seed, max_tokens=CAP,
                stream=kind == "stream",
                prompt_dir=prompt_dir if kind == "cloned" else None,
                on_chunk=lambda h, a: frames.append(a) if "chunk" in h
                else None)
            out[kind] = (hdr, audio, frames)
        except Exception as e:
            errors.append((kind, e))

    threads = [threading.Thread(target=call, args=(i, *r))
               for i, r in enumerate(DP_REQUESTS)]
    # the priority flag is not on DaemonClient's surface: a raw request
    for th in threads[:3]:
        th.start()
    msg = json.dumps({"text": DP_REQUESTS[3][0], "language": "english",
                      "seed": DP_REQUESTS[3][1], "priority": 5,
                      "max_tokens": CAP}).encode()
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    c.connect(sock)
    c.sendall(struct.pack("<I", len(msg)) + msg)
    raw = tdaemon._recv_exact(c, 4)
    payload = tdaemon._recv_exact(c, struct.unpack("<I", raw)[0])
    c.close()
    hdr, audio = tdaemon.decode_response(payload)
    out["priority"] = (hdr, audio, [])
    for th in threads[:3]:
        th.join(timeout=120)
    assert not errors, errors
    _vanish(sock)
    # the vanished request leaves the batch before the next one is sent
    deadline = time.time() + 60
    while time.time() < deadline:
        st = tdaemon.DaemonClient(sock).stats()
        if st["errors"] >= 1 and st["batcher"]["active_slots"] == 0:
            break
        time.sleep(0.1)
    out["stats"] = st
    out["after"] = tdaemon.DaemonClient(sock).synthesize(
        AFTER[0], language="english", seed=AFTER[1],
        max_tokens=CAP) + ([],)
    return out


def _reference(prompt_dir: str) -> dict:
    """The dp 2 daemon's requests through an in-process no-mesh batcher
    over the daemon's weights (TTSEngine's seed 0)."""
    eng = TTSEngine(TINY, dtype=torch.float32, device="cpu", seed=0)
    b = ContinuousBatcher(eng.cfg, eng.params, batch_size=4, decode_chunk=4,
                          dtype=torch.float32, device="cpu")
    futs, segs = {}, []
    for text, seed, kind in DP_REQUESTS + (AFTER + ("after",),):
        kw = {}
        if kind == "cloned":
            ref_codes, ref_text = eng._load_prompt(prompt_dir)
            ids, n, kw["n_target"] = eng._encode_cloned(text, ref_text)
            kw["ref_codes"] = ref_codes
        else:
            ids, n = eng._encode_text(text)
        if kind == "stream":
            kw["on_chunk"] = segs.append
        futs[kind] = b.submit(np.asarray(ids), int(n), seed=seed,
                              max_tokens=CAP, **kw)
    for _ in range(400):
        if all(f.done() for f in futs.values()):
            break
        b.step()
    out = {k: f.result(timeout=0) for k, f in futs.items()}
    out["segments"] = np.concatenate(segs)
    return out


def _tp2_requests(sock: str) -> dict:
    client = tdaemon.DaemonClient(sock)
    frames = []
    out = {"blob": client.synthesize("mesh daemon", seed=3,
                                     language="english", max_tokens=CAP)}
    out["stream"] = client.synthesize(
        "mesh daemon", seed=3, language="english", stream=True,
        max_tokens=CAP,
        on_chunk=lambda h, a: frames.append(a) if "chunk" in h else None)
    out["frames"] = frames
    return out


@pytest.fixture(scope="module")
def daemons(tmp_path_factory):
    """Both daemons' results, logs and exits, and the reference: the two
    start together, the reference runs while they start, and their
    clients run side by side."""
    tmp = tmp_path_factory.mktemp("daemon_mesh")
    prompt_dir = _prompt_dir(tmp)
    procs = {"tp2": _start(tmp, "tp2", ["--batch", "4", "--tp", "2",
                                        "--dp", "2"]),
             "dp2": _start(tmp, "dp2", ["--batch", "4", "--tp", "1",
                                        "--dp", "2"])}
    try:
        got = {"reference": _reference(prompt_dir)}
        drive = {"dp2": lambda s: _dp_requests(s, prompt_dir),
                 "tp2": _tp2_requests}
        errors = []

        def run(name):
            proc, sock = procs[name]
            try:
                _wait(proc, sock)
                got[name] = drive[name](sock)
            except BaseException as e:
                errors.append((name, e))
            got[name + "_log"] = _stop(proc)
            got[name + "_rc"] = proc.returncode
            got[name + "_sock_left"] = os.path.exists(sock)

        threads = [threading.Thread(target=run, args=(n,)) for n in procs]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        assert not errors, (errors, got.get("dp2_log"), got.get("tp2_log"))
        return got
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


@pytest.fixture(scope="module")
def reference(daemons):
    return daemons["reference"]


def _summaries(log: str) -> list:
    line = next(ln for ln in log.splitlines()
                if ln.startswith("lockstep ranks at stop: "))
    return ast.literal_eval(line.split(": ", 1)[1])


def test_tp2_dp2_daemon_serves_and_drains(daemons):
    log = daemons["tp2_log"]
    assert daemons["tp2_rc"] == 0, log
    assert "mesh dp2xtp2 over 4 device(s)" in log
    assert not daemons["tp2_sock_left"]
    hdr, audio = daemons["tp2"]["blob"]
    assert hdr["n_tokens"] > 0 and len(audio) == hdr["n_tokens"] * 1920
    shdr, saudio = daemons["tp2"]["stream"]
    frames = daemons["tp2"]["frames"]
    assert frames and np.array_equal(np.concatenate(frames), saudio)
    assert shdr["n_tokens"] == hdr["n_tokens"]
    diff = np.abs(saudio.astype(np.int32) - audio.astype(np.int32))
    assert diff.max() <= 1
    sums = _summaries(log)
    assert [s["rank"] for s in sums] == [0, 1, 2, 3]
    assert len({s["steps"] for s in sums}) == 1
    assert all(s["active_slots"] == 0 and s["queued"] == 0 for s in sums)


@pytest.mark.parametrize("kind", ["blob", "stream", "cloned", "priority",
                                  "after"])
def test_dp2_daemon_equals_no_mesh_batcher(daemons, reference, kind):
    hdr, audio, frames = daemons["dp2"][kind]
    codes, want = reference[kind]
    assert hdr["n_tokens"] == len(codes) > 0
    np.testing.assert_array_equal(audio, want)
    if kind == "stream":
        np.testing.assert_array_equal(np.concatenate(frames),
                                      reference["segments"])


def test_dp2_vanished_client_frees_its_slot_on_both_ranks(daemons):
    log = daemons["dp2_log"]
    assert daemons["dp2_rc"] == 0, log
    assert "mesh dp2xtp1 over 2 device(s)" in log
    assert not daemons["dp2_sock_left"]
    st = daemons["dp2"]["stats"]
    assert st["errors"] == 1 and st["batcher"]["active_slots"] == 0, st
    sums = _summaries(log)
    assert [s["rank"] for s in sums] == [0, 1]
    assert sums[0]["steps"] == sums[1]["steps"]
    for s in sums:
        # cancelled mid-decode on both ranks; nothing left in a slot
        assert s["cancelled"] == 1 and s["active_slots"] == 0, s
        assert s["queued"] == 0, s
    # warm-up and six requests, served by the rank that holds each slot
    assert sums[0]["served"] + sums[1]["served"] == 6


def test_step_message_round_trips_through_the_encoder():
    """The front end's message (no ranks): arrival order, every field of
    a submission, a cancellation sent once, a request cancelled before it
    was sent failing at once, and the stop."""

    class _Stub:
        def occupancy(self):
            return {"queued": 0}

    front = lockstep.LockstepFront(lockstep.LockstepRank(_Stub(), None))
    ref = np.arange(32, dtype=np.int32).reshape(2, 16)
    f0 = front.submit(np.array([5, 6, 7]), 3, seed=11, max_tokens=9,
                      priority=2)
    f1 = front.submit(np.array([8]), 1, seed=12, on_chunk=print,
                      ref_codes=ref, n_target=1)
    f2 = front.submit(np.array([9]), 1, seed=13)
    f2.request.cancelled = True
    with pytest.raises(ValueError):
        front.submit(np.array([1]), 1, ref_codes=ref)
    wire = lockstep.encode_message(front.take_message())
    msg = lockstep.decode_message(pickle.loads(pickle.dumps(wire)))
    assert [s.id for s in msg.subs] == [0, 1] and not msg.stop
    a, b = msg.subs
    assert (a.text_ids.tolist(), a.n_text, a.seed, a.max_tokens,
            a.priority, a.stream, a.ref_codes, a.n_target) == (
        [5, 6, 7], 3, 11, 9, 2, False, None, None)
    assert (b.stream, b.n_target, b.max_tokens) == (True, 1, None)
    np.testing.assert_array_equal(b.ref_codes, ref)
    assert a.text_ids.dtype == np.int32
    assert "cancelled" in str(f2.exception(timeout=0))
    f1.request.cancelled = True
    assert front.take_message().cancel == [1]
    assert front.take_message().cancel == []     # sent once
    front._stop_now = True
    assert lockstep.decode_message(lockstep.encode_message(
        front.take_message())).stop
    assert not f0.done()


@pytest.mark.parametrize("case", ["fewer_cards", "user_world"])
def test_multi_rank_daemon_refusals_before_any_rank(case, monkeypatch,
                                                    capsys):
    """Exit 2 before any rank starts: fewer cards than dp x tp ranks
    ("need N devices", as cli --tp), and a world its caller set up
    (QWEN3_TTS_NUM_PROCESSES > 1: the daemon starts its own ranks)."""
    started = []
    monkeypatch.setattr(tdaemon, "_launch_ranks",
                        lambda n, argv: started.append(n) or 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    if case == "user_world":
        monkeypatch.setenv("QWEN3_TTS_NUM_PROCESSES", "2")
    with pytest.raises(SystemExit) as e:
        tdaemon.main(["--tiny", "--batch", "4", "--tp", "2", "--dp", "2"])
    assert e.value.code == 2 and not started
    err = capsys.readouterr().err
    assert ("need 4 devices" if case == "fewer_cards"
            else "multi-process daemon serving") in err
    monkeypatch.delenv("QWEN3_TTS_NUM_PROCESSES", raising=False)
    # without --dp, dp spans the host's cards over tp: 2 cards, tp 1
    assert tdaemon.main(["--tiny", "--batch", "4", "--tp", "1"]) == 0
    assert started == [2]
