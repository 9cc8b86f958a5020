"""ContinuousBatcher(mesh=...) of the port on the CPU, ranks over gloo
(tests/torch_mesh_worker.py, one spawn a configuration), at
tests/test_engine_mesh.py's _mesh_cfg geometry in f32; and the daemon's
``--tp``/``--dp``.

- dp = 2, tp = 1 (the twin of tests/test_multihost.py::
  test_two_process_dcn_serving), dense and paged, six sampled requests
  through four slots, one streaming, the int8 code predictor on K2: dp
  issues no collective on the data path, so every request's codes and
  audio equal the one-device batcher's bit for bit, and the two ranks'
  served sets partition the requests.
- dp = 2, tp = 2 over four ranks, greedy: the JAX test_batcher_on_mesh
  configuration (two slots, three requests) on the JAX batcher over a
  (2, 2) virtual mesh; every request's codes are equal (the tp ranks add
  up in another order than JAX, f32 noise far below a greedy margin).
"""

import dataclasses
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qwen3_tts_tpu import config as C
from qwen3_tts_tpu.io import weights as jweights
from qwen3_tts_tpu.parallel import mesh as jmesh
from qwen3_tts_tpu.serve.batching import ContinuousBatcher as JBatcher
from qwen3_tts_tpu_torch import config as pconfig
from qwen3_tts_tpu_torch.io import weights as tweights
from qwen3_tts_tpu_torch.serve import daemon as tdaemon
from qwen3_tts_tpu_torch.serve.batching import ContinuousBatcher

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_mesh_worker as W  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GREEDY = C.SamplingConfig(temperature=0.0, repetition_penalty=1.0,
                          cp_temperature=0.0)


def _mesh_cfg(max_tokens=6):
    talker = C.TalkerConfig(
        num_layers=2, hidden_size=64, intermediate_size=128,
        num_heads=8, num_kv_heads=4, head_dim=16,
        text_vocab_size=151936, text_embed_dim=32, codec_vocab_size=3072,
        max_seq_len=64)
    cp_cfg = C.CodePredictorConfig(
        num_layers=2, hidden_size=64, intermediate_size=128,
        num_heads=8, num_kv_heads=4, head_dim=16)
    return dataclasses.replace(C.tiny_tts_config(max_tokens=max_tokens),
                               talker=talker, code_predictor=cp_cfg)


def _pcfg(jcfg):
    def part(cls, obj):
        return cls(**{f.name: getattr(obj, f.name)
                      for f in dataclasses.fields(cls)})
    return pconfig.TTSConfig(
        talker=part(pconfig.TalkerConfig, jcfg.talker),
        code_predictor=part(pconfig.CodePredictorConfig,
                            jcfg.code_predictor),
        vocoder=part(pconfig.VocoderConfig, jcfg.vocoder),
        sampling=part(pconfig.SamplingConfig, jcfg.sampling),
        max_tokens=jcfg.max_tokens)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items() if k != "layers_list"}
    return np.asarray(tree)


def _drain(b, futs):
    for _ in range(600):
        if all(f.done() for f in futs):
            break
        b.step()
    return [f.result(timeout=1) for f in futs]


# the dp = 2 schedule: six requests through four slots, request 2 streams
DP_REQUESTS = [(np.asarray((np.arange(4 + i % 3) * 7 + i * 13) % 997,
                           np.int32), 4 + i % 3, 100 + i) for i in range(6)]
DP_STREAM = 2


@pytest.fixture(scope="module")
def dp2(tmp_path_factory):
    """The two dp ranks' outputs and the one-device batcher's results,
    dense and paged."""
    cfg = _pcfg(_mesh_cfg(max_tokens=8))
    params = tweights.init_random_params(cfg, seed=0, dtype=torch.float32)
    d = tmp_path_factory.mktemp("batching_dp2")
    tweights.save_pytree_npz(str(d / "params.npz"), params, config=cfg)
    W.write_schedule(str(d / "in.npz"), DP_REQUESTS, batch=4,
                     stream=DP_STREAM)
    ranks = W.start_ranks("batcher", 2, 1, str(d))
    want = {}
    for paged in (False, True):
        b = ContinuousBatcher(cfg, params, batch_size=4, decode_chunk=4,
                              dtype=torch.float32, device="cpu", paged=paged,
                              page_size=16)
        futs = [b.submit(ids, n, seed=seed) for ids, n, seed in DP_REQUESTS]
        want[paged] = (_drain(b, futs), b.pool_pages if paged else 0)
    return want, ranks.result()


@pytest.mark.parametrize("paged", [False, True])
def test_dp2_results_equal_one_device_bit_for_bit(dp2, paged):
    want, outs = dp2
    tag = "paged" if paged else "dense"
    served = 0
    for o in outs:
        for i in o[f"{tag}_owned"]:
            codes, audio = want[paged][0][i]
            np.testing.assert_array_equal(o[f"{tag}_codes{i}"], codes)
            np.testing.assert_array_equal(o[f"{tag}_audio{i}"], audio)
            assert len(audio) == len(codes) * 1920
            served += 1
    assert served == len(DP_REQUESTS)


@pytest.mark.parametrize("paged", [False, True])
def test_dp2_served_sets_partition_the_requests(dp2, paged):
    """Each request is served by the rank of the dp group that holds its
    slot, and by no other; both ranks served some. Each rank holds half
    the slots' KV, paged in a sub-pool of its own, whose pages all came
    back."""
    want, outs = dp2
    tag = "paged" if paged else "dense"
    owned = [set(o[f"{tag}_owned"].tolist()) for o in outs]
    assert all(owned) and not (owned[0] & owned[1])
    assert owned[0] | owned[1] == set(range(len(DP_REQUESTS)))
    assert [tuple(o["coords"]) for o in outs] == [(0, 0), (1, 0)]
    for o in outs:
        shape = tuple(o[f"{tag}_local_shape"])
        if paged:
            # the one-device pool is 4 slots' pages and page 0; a group's
            # sub-pool is its 2 slots' pages and its own page 0
            per_group = 2 * ((want[True][1] - 1) // 4) + 1
            assert shape == (2, 2, per_group, 16, 4, 16)
            assert int(o["paged_free_pages"]) == 2 * (per_group - 1)
        else:
            assert shape == (2, 2, 2, 64, 4, 16)


def test_dp2_streaming_request_segments_make_its_audio(dp2):
    _, outs = dp2
    for tag in ("dense", "paged"):
        o = next(o for o in outs if DP_STREAM in o[f"{tag}_owned"])
        np.testing.assert_array_equal(o[f"{tag}_segments"],
                                      o[f"{tag}_audio{DP_STREAM}"])


def _ids(text):
    """tests/test_batching.py's ids of a text."""
    arr = np.zeros(8, np.int32)
    raw = [ord(c) % 1000 for c in text][:8]
    arr[:len(raw)] = raw
    return arr, len(raw)


def test_dp2_tp2_codes_equal_jax_batcher_on_mesh(tmp_path):
    """tests/test_batching.py::test_batcher_on_mesh's configuration,
    greedy, at dp = 2 x tp = 2: the JAX batcher on a (2, 2) virtual
    mesh and four port ranks, dense and paged, give every request the
    same codes; the one streaming request's segments make its audio."""
    jcfg = dataclasses.replace(_mesh_cfg(), sampling=GREEDY)
    jp = jweights.init_random_params(jcfg, seed=0, dtype=jnp.float32)
    reqs = [(*_ids(t), i) for i, t in
            enumerate(["mesh a", "mesh bb", "mesh ccc"])]
    cfg, params = _pcfg(jcfg), tweights.from_jax_numpy(_np(jp))
    tweights.save_pytree_npz(str(tmp_path / "params.npz"), params,
                             config=cfg)
    W.write_schedule(str(tmp_path / "in.npz"), reqs, batch=2, stream=1)
    ranks = W.start_ranks("batcher", 2, 2, str(tmp_path))
    mesh = jmesh.make_mesh(2, 2)
    with mesh:
        b = JBatcher(jcfg, jp, batch_size=2, decode_chunk=4,
                     dtype=jnp.float32, mesh=mesh)
        want = _drain(b, [b.submit(ids, n, seed=s) for ids, n, s in reqs])
    outs = ranks.result()
    for tag in ("dense", "paged"):
        served = {i: o for o in outs for i in o[f"{tag}_owned"].tolist()}
        assert sorted(served) == [0, 1, 2]
        for i, (codes, _) in enumerate(want):
            np.testing.assert_array_equal(served[i][f"{tag}_codes{i}"],
                                          np.asarray(codes))
        np.testing.assert_array_equal(served[1][f"{tag}_segments"],
                                      served[1][f"{tag}_audio1"])
    # only tp rank 0 of a group serves
    assert all(len(o["dense_owned"]) == 0 for o in outs
               if o["coords"][1] == 1)


def test_daemon_mesh_flags_validation():
    """--dp/--tp misuse exits 2 before any engine is built (the JAX
    daemon's checks): mesh flags without --batch, and a batch dp does not
    divide."""
    base = ["--tiny", "--device", "cpu"]
    with pytest.raises(SystemExit) as e:
        tdaemon.main(base + ["--tp", "2"])
    assert e.value.code == 2
    with pytest.raises(SystemExit) as e:
        tdaemon.main(base + ["--batch", "3", "--tp", "2", "--dp", "2"])
    assert e.value.code == 2


def test_daemon_one_rank_mesh_serves(tmp_path):
    """``--tp 1 --batch 2``: the batched daemon over a one-rank mesh
    reports it, serves a request and drains on SIGTERM."""
    sock = str(tmp_path / "mesh.sock")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "qwen3_tts_tpu_torch.serve.daemon", "--tiny",
         "--device", "cpu", "--dtype", "float32", "--batch", "2", "--tp",
         "1", "--decode_chunk", "4", "--python_loop", "--socket", sock],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        deadline = time.time() + 100
        while not os.path.exists(sock):
            assert proc.poll() is None, proc.stdout.read().decode(
                errors="replace")
            assert time.time() < deadline, "the socket never appeared"
            time.sleep(0.1)
        hdr, audio = tdaemon.DaemonClient(sock).synthesize(
            "mesh daemon", language="english", seed=3)
        assert hdr["n_tokens"] > 0 and len(audio) == hdr["n_tokens"] * 1920
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        out = out.decode(errors="replace")
        assert proc.returncode == 0, out
        assert "mesh dp1xtp1 over 1 device(s)" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
