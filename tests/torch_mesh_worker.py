"""Rank process of the port's multi-device tests (tests/
test_torch_parallel.py, test_torch_engine_mesh.py,
test_torch_batching_mesh.py on the CPU, and test_torch_cuda.py on four
cards); launched by ``run_ranks``, not collected by pytest. It imports no
jax.

    python tests/torch_mesh_worker.py MODE DP TP IO_DIR [DEVICE]

Every rank joins a world through the QWEN3_TTS_* variables (a file store
in IO_DIR, so no TCP port can clash): gloo on the CPU (DEVICE "cpu", the
default), or rank r on cuda:r over NCCL (DEVICE "cuda"). It builds the
dp x tp mesh, reads its inputs from IO_DIR (``params.npz`` with its config,
``in.npz``), runs MODE and writes what it got to IO_DIR/out<rank>.npz;
the parent test compares. Modes:

- ``layers``: one transformer layer stack's decode step (the stack, x,
  pos and kv of in.npz) and the int8 code predictor's greedy codes
  (``cp.npz``, hidden, c0e) on this rank's shards;
- ``engine``: TTSEngine(mesh=...) dense and int8-cp on ENGINE_REQUESTS,
  whole and (dense) streaming, and the dense engine's ``kv_cache_dir``
  file written and restored by a fresh engine;
- ``batcher``: ContinuousBatcher(mesh=...) dense and paged, in
  lockstep, on the schedule that write_schedule put in in.npz; each rank
  writes the requests it served (the others resolve to the (None, None)
  marker), the free pages and its local KV shape.
"""

from __future__ import annotations

import os
import sys
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (text, seed) of the engine mode: the JAX engine mesh tests' texts
ENGINE_REQUESTS = (("mesh engine", 3), ("stream on mesh", 5))


def write_schedule(path: str, requests, batch: int, decode_chunk: int = 4,
                   quantize_cp: bool = True, stream: int = -1) -> None:
    """The batcher mode's inputs: the requests [(ids, n_text, seed)] in
    submission order, the batcher's batch and chunk, and which request
    streams (-1: none)."""
    arrays = {"batch": batch, "decode_chunk": decode_chunk,
              "quantize_cp": quantize_cp, "stream": stream,
              "n_req": len(requests)}
    for i, (ids, n, seed) in enumerate(requests):
        arrays.update({f"ids{i}": ids, f"n{i}": n, f"seed{i}": seed})
    np.savez(path, **arrays)


def read_schedule(path: str) -> dict:
    with np.load(path) as d:
        reqs = [(d[f"ids{i}"], int(d[f"n{i}"]), int(d[f"seed{i}"]))
                for i in range(int(d["n_req"]))]
        return dict(requests=reqs, batch=int(d["batch"]),
                    decode_chunk=int(d["decode_chunk"]),
                    quantize_cp=bool(d["quantize_cp"]),
                    stream=int(d["stream"]))


def run_ranks(mode: str, dp: int, tp: int, io_dir: str,
              timeout: float = 120.0, device: str = "cpu") -> list:
    """Run MODE on dp*tp ranks and return each rank's outputs (dicts of
    arrays). A rank that fails, or a run past ``timeout`` seconds, ends
    every rank and raises with the ranks' output."""
    from qwen3_tts_tpu_torch.parallel import multihost as mh
    n = dp * tp
    exits = mh.spawn_ranks(
        [sys.executable, os.path.abspath(__file__), mode, str(dp), str(tp),
         io_dir, device], n, io_dir, timeout=timeout,
        env={"PYTHONPATH": ROOT, "JAX_PLATFORMS": "cpu"})
    if any(e.code for e in exits):
        raise AssertionError(f"mode {mode} dp{dp}xtp{tp} failed:\n"
                             + mh.format_exits(exits))
    outs = []
    for r in range(n):
        with np.load(os.path.join(io_dir, f"out{r}.npz")) as d:
            outs.append({k: d[k] for k in d.files})
    return outs


def start_ranks(*args, **kw):
    """run_ranks in a thread of its own: a Future of its result, so that
    the parent computes its references while the ranks run."""
    from concurrent.futures import ThreadPoolExecutor
    pool = ThreadPoolExecutor(1)
    fut = pool.submit(run_ranks, *args, **kw)
    pool.shutdown(wait=False)
    return fut


def _layers(mesh, io_dir: str) -> dict:
    import torch
    from qwen3_tts_tpu_torch.io import weights as tw
    from qwen3_tts_tpu_torch.models import code_predictor as tcp
    from qwen3_tts_tpu_torch.models import transformer as tfm
    from qwen3_tts_tpu_torch.parallel import mesh as pmesh
    from qwen3_tts_tpu_torch.ops import sampling as smp
    cfg = tw.read_npz_config(os.path.join(io_dir, "params.npz"))
    stack = tw.load_pytree_npz(os.path.join(io_dir, "params.npz"))
    stack = pmesh.shard_params(mesh, {"talker": stack})["talker"]
    with np.load(os.path.join(io_dir, "in.npz")) as d:
        x, pos, kv = (torch.from_numpy(d[k]) for k in ("x", "pos", "kv"))
        hidden, c0e = (torch.from_numpy(d[k]) for k in ("hidden", "c0e"))
    kv = pmesh.shard_leaf(kv, 4, mesh)      # (L, 2, B, S, Hkv, Dh)
    geo = tfm.geometry_of(cfg.talker, mesh)
    h, kv = tfm.decode_step(stack["layers"], x, pos.long(), kv, geo, mesh)
    cp = tw.load_pytree_npz(os.path.join(io_dir, "cp.npz"))
    cp = pmesh.shard_params(mesh, {"code_predictor": cp})["code_predictor"]
    seeds = smp.token_seeds(smp.batch_keys(0, hidden.shape[0]),
                            torch.zeros(hidden.shape[0]))[:, 1:]
    codes = tcp.predict_codes(cp, hidden, c0e, seeds, cfg.code_predictor,
                              cfg.sampling, mesh)
    return {"hidden": h.numpy(), "kv": kv.numpy(), "codes": codes.numpy()}


def _engine(mesh, io_dir: str) -> dict:
    import torch
    from qwen3_tts_tpu_torch.engine.engine import TTSEngine
    from qwen3_tts_tpu_torch.io import weights as tw
    path = os.path.join(io_dir, "params.npz")
    cfg, params = tw.read_npz_config(path), tw.load_pytree_npz(path)
    out = {}
    for q in (None, "int8-cp"):
        eng = TTSEngine(cfg, params=params, dtype=torch.float32,
                        quantize=q, mesh=mesh)
        for i, (text, seed) in enumerate(ENGINE_REQUESTS):
            res = eng.synthesize(text, language="english", seed=seed)
            out[f"{q}_codes{i}"] = res.codes
            out[f"{q}_audio{i}"] = res.audio_int16
        if q is None:
            segs = []
            text, seed = ENGINE_REQUESTS[1]
            res = eng.synthesize(text, language="english", seed=seed,
                                 streaming=True, on_chunk=segs.append)
            out["stream_codes"] = res.codes
            out["stream_audio"] = res.audio_int16
            out["stream_segments"] = np.concatenate(segs)
            out.update(_kv_cache_dir(eng, cfg, params, mesh, io_dir))
    return out


def _kv_cache_dir(eng, cfg, params, mesh, io_dir: str) -> dict:
    """``kv_cache_dir`` under tp: the first request of ENGINE_REQUESTS
    prefilled and written (tp rank 0 writes the whole state), then a
    fresh engine restoring it from the file with no prefill."""
    import torch
    from qwen3_tts_tpu_torch.engine.engine import TTSEngine
    kv_dir = os.path.join(io_dir, "kv")
    os.makedirs(kv_dir, exist_ok=True)
    text, seed = ENGINE_REQUESTS[0]
    eng._prefix_cache.clear()
    eng.kv_cache_dir = kv_dir
    first = eng.synthesize(text, language="english", seed=seed)
    fresh = TTSEngine(cfg, params=params, dtype=torch.float32, mesh=mesh)
    fresh.kv_cache_dir = kv_dir
    prefills = []
    real = fresh._prefill_state
    fresh._prefill_state = lambda *a: prefills.append(1) or real(*a)
    again = fresh.synthesize(text, language="english", seed=seed)
    return {"kv_first_codes": first.codes, "kv_first_audio":
            first.audio_int16, "kv_loaded_codes": again.codes,
            "kv_loaded_audio": again.audio_int16,
            "kv_prefills": np.int32(len(prefills)),
            "kv_files": np.asarray(sorted(os.listdir(kv_dir)))}


def _batcher(mesh, io_dir: str) -> dict:
    import torch
    from qwen3_tts_tpu_torch.io import weights as tw
    from qwen3_tts_tpu_torch.serve.batching import ContinuousBatcher
    path = os.path.join(io_dir, "params.npz")
    cfg, params = tw.read_npz_config(path), tw.load_pytree_npz(path)
    sch = read_schedule(os.path.join(io_dir, "in.npz"))
    out = {}
    for paged in (False, True):
        b = ContinuousBatcher(cfg, params, batch_size=sch["batch"],
                              decode_chunk=sch["decode_chunk"],
                              dtype=torch.float32, mesh=mesh, paged=paged,
                              page_size=16, quantize_cp=sch["quantize_cp"])
        segs = []
        futs = [b.submit(ids, n, seed=seed,
                         on_chunk=segs.append if i == sch["stream"] else None)
                for i, (ids, n, seed) in enumerate(sch["requests"])]
        for _ in range(400):
            if all(f.done() for f in futs):
                break
            b.step()
        tag = "paged" if paged else "dense"
        owned = []
        for i, f in enumerate(futs):
            codes, audio = f.result(timeout=0)
            if codes is None:
                continue
            owned.append(i)
            out[f"{tag}_codes{i}"] = codes
            out[f"{tag}_audio{i}"] = audio
            if i == sch["stream"]:
                out[f"{tag}_segments"] = np.concatenate(segs)
        out[f"{tag}_owned"] = np.asarray(owned, np.int32)
        out[f"{tag}_free_pages"] = np.int32(len(b._free_pages))
        out[f"{tag}_local_shape"] = np.asarray(b._state.kv.pool.shape
                                               if paged else
                                               b._state.kv.shape)
    return out


def main() -> int:
    mode, dp, tp, io_dir = (sys.argv[1], int(sys.argv[2]),
                            int(sys.argv[3]), sys.argv[4])
    device = sys.argv[5] if len(sys.argv) > 5 else "cpu"
    import torch
    from qwen3_tts_tpu_torch.parallel import mesh as pmesh
    from qwen3_tts_tpu_torch.parallel import multihost as mh
    torch.set_num_threads(1)
    rank = int(os.environ["QWEN3_TTS_PROCESS_ID"])
    try:
        assert mh.init_distributed(device="cpu" if device == "cpu"
                                   else None)
        mesh = pmesh.make_mesh(dp, tp)
        with torch.inference_mode():
            out = {"layers": _layers, "engine": _engine,
                   "batcher": _batcher}[mode](mesh, io_dir)
        out["coords"] = np.asarray([mesh.dp_index, mesh.tp_index])
        np.savez(os.path.join(io_dir, f"out{rank}.npz"), **out)
        mh.barrier("done", timeout_s=60)
    except BaseException:
        traceback.print_exc()
        mh.shutdown_distributed()
        return 1
    mh.shutdown_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())
