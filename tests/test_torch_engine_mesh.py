"""TTSEngine(mesh=...) of the port on the CPU: a tp = 2 engine over two
gloo ranks (tests/torch_mesh_worker.py, one spawn for every check) at
tests/test_engine_mesh.py's _mesh_cfg geometry, f32 and greedy, against
the JAX TTSEngine(mesh=make_mesh(1, 2)) on the conftest's virtual CPU
mesh and against the port without a mesh; the engine's guard rails; and
the CLI's ``--tp``.

Greedy codes are compared equal: the tp ranks add their o and down
products up in another order than one device, f32 noise far below any
greedy margin at this size. The dense engine's audio is compared bit for
bit (the same codes through the same replicated vocoder). The int8-cp
engine is held to JAX only: under tp its code predictor runs the
per-step path (K1 over the shards), as JAX's does on the CPU, while the
port's one-device int8-cp engine runs K2, whose bf16 activations give
other greedy codes (tests/test_torch_parallel.py shows the per-step
paths equal).
"""

import dataclasses
import os
import subprocess
import sys
import wave

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qwen3_tts_tpu import config as C
from qwen3_tts_tpu.engine.engine import TTSEngine as JEngine
from qwen3_tts_tpu.io import weights as jweights
from qwen3_tts_tpu.parallel import mesh as jmesh
from qwen3_tts_tpu_torch import cli
from qwen3_tts_tpu_torch import config as pconfig
from qwen3_tts_tpu_torch.engine.engine import TTSEngine
from qwen3_tts_tpu_torch.io import weights as tweights
from qwen3_tts_tpu_torch.parallel import mesh as pmesh

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_mesh_worker as W  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GREEDY = C.SamplingConfig(temperature=0.0, repetition_penalty=1.0,
                          cp_temperature=0.0)


def _mesh_cfg():
    talker = C.TalkerConfig(
        num_layers=2, hidden_size=64, intermediate_size=128,
        num_heads=8, num_kv_heads=4, head_dim=16,
        text_vocab_size=151936, text_embed_dim=32, codec_vocab_size=3072,
        max_seq_len=64)
    cp_cfg = C.CodePredictorConfig(
        num_layers=2, hidden_size=64, intermediate_size=128,
        num_heads=8, num_kv_heads=4, head_dim=16)
    return dataclasses.replace(C.tiny_tts_config(max_tokens=6),
                               talker=talker, code_predictor=cp_cfg,
                               sampling=GREEDY)


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


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX mesh engine's codes, the port's one-device engine's codes
    and audio, and the two tp ranks' outputs."""
    jcfg = _mesh_cfg()
    jp = jweights.init_random_params(jcfg, seed=0, dtype=jnp.float32)
    cfg, params = _pcfg(jcfg), tweights.from_jax_numpy(_np(jp))
    d = tmp_path_factory.mktemp("engine_mesh")
    tweights.save_pytree_npz(str(d / "params.npz"), params, config=cfg)
    ranks = W.start_ranks("engine", 1, 2, str(d))
    want = {}
    mesh = jmesh.make_mesh(1, 2)
    for q in (None, "int8-cp"):
        with mesh:
            eng = JEngine(jcfg, model_dir=None, dtype=jnp.float32,
                          params=dict(jp), quantize=q, mesh=mesh)
            for i, (text, seed) in enumerate(W.ENGINE_REQUESTS):
                want[f"jax_{q}_codes{i}"] = np.asarray(eng.synthesize(
                    text, language="english", seed=seed).codes)
    one = TTSEngine(cfg, params=params, dtype=torch.float32, device="cpu")
    for i, (text, seed) in enumerate(W.ENGINE_REQUESTS):
        res = one.synthesize(text, language="english", seed=seed)
        want[f"one_codes{i}"], want[f"one_audio{i}"] = (res.codes,
                                                        res.audio_int16)
    # the one-device engine's kv_cache_dir file of the first prompt
    one_dir = d / "kv_one"
    one_dir.mkdir()
    one._prefix_cache.clear()
    one.kv_cache_dir = str(one_dir)
    text, seed = W.ENGINE_REQUESTS[0]
    one.synthesize(text, language="english", seed=seed)
    want["dir"], want["jax_engine"] = d, eng
    return want, ranks.result()


@pytest.mark.parametrize("quantize", [None, "int8-cp"])
def test_tp2_engine_codes_equal_jax_mesh_engine(run, quantize):
    want, outs = run
    for i in range(len(W.ENGINE_REQUESTS)):
        got = outs[0][f"{quantize}_codes{i}"]
        assert len(got) > 0
        np.testing.assert_array_equal(got, want[f"jax_{quantize}_codes{i}"])


def test_tp2_dense_engine_equals_one_device(run):
    want, outs = run
    for i in range(len(W.ENGINE_REQUESTS)):
        np.testing.assert_array_equal(outs[0][f"None_codes{i}"],
                                      want[f"one_codes{i}"])
        np.testing.assert_array_equal(outs[0][f"None_audio{i}"],
                                      want[f"one_audio{i}"])
        assert len(outs[0][f"None_audio{i}"]) == len(want[
            f"one_codes{i}"]) * 1920


def test_tp2_ranks_return_the_same_result(run):
    """The engine is SPMD: both ranks return the same codes and audio."""
    _, outs = run
    assert [tuple(o["coords"]) for o in outs] == [(0, 0), (0, 1)]
    for k in outs[0]:
        if k != "coords":
            np.testing.assert_array_equal(outs[0][k], outs[1][k], err_msg=k)


def test_tp2_streaming_equals_the_blob(run):
    """Streaming on the mesh: the blob's codes, and the on_chunk pieces
    make up the streamed audio."""
    _, outs = run
    o = outs[0]
    np.testing.assert_array_equal(o["stream_codes"], o["None_codes1"])
    np.testing.assert_array_equal(o["stream_segments"], o["stream_audio"])
    assert len(o["stream_audio"]) == len(o["stream_codes"]) * 1920


def test_tp2_kv_cache_file_restores_the_prefilled_codes(run):
    """A tp 2 engine writes one whole-state file; a fresh tp 2 engine
    restores it (no prefill) to the first run's codes and audio bit for
    bit, on both ranks."""
    _, outs = run
    for o in outs:
        assert len(o["kv_files"]) == 1
        assert int(o["kv_prefills"]) == 0
        assert len(o["kv_first_codes"]) > 0
        np.testing.assert_array_equal(o["kv_loaded_codes"],
                                      o["kv_first_codes"])
        np.testing.assert_array_equal(o["kv_loaded_audio"],
                                      o["kv_first_audio"])
        np.testing.assert_array_equal(o["kv_first_codes"], o["None_codes0"])


def test_tp2_kv_cache_file_is_the_one_device_file(run):
    """The tp 2 file holds the whole state in the one-device engine's
    format: its kv heads in shard order equal the one-device file's
    within the tp tolerance (tests/test_torch_parallel.py's f32 atol
    1e-5), every other field exactly; and the JAX engine reads it."""
    want, outs = run
    d = want["dir"]
    name = str(outs[0]["kv_files"][0])
    assert sorted(os.listdir(d / "kv_one")) == [name]
    with np.load(d / "kv" / name) as tp_file, \
            np.load(d / "kv_one" / name) as one_file:
        assert sorted(tp_file.files) == sorted(one_file.files)
        kv_shape = one_file["kv"].shape
        for k in one_file.files:
            assert tp_file[k].shape == one_file[k].shape, k
            if k in ("kv", "hidden"):
                np.testing.assert_allclose(tp_file[k], one_file[k],
                                           atol=1e-5, rtol=0, err_msg=k)
            else:
                np.testing.assert_array_equal(tp_file[k], one_file[k],
                                              err_msg=k)
    import jax
    state = want["jax_engine"]._load_state_npz(str(d / "kv" / name),
                                                jax.random.PRNGKey(0))
    assert state.kv.shape == kv_shape


def test_engine_mesh_guard_rails():
    """A dp > 1 mesh and quantize="int8" (the fused single-device talker
    layout) are refused before any weight is built, as in JAX."""
    cfg = _pcfg(_mesh_cfg())
    with pytest.raises(ValueError, match="dp=1"):
        TTSEngine(cfg, mesh=pmesh.make_mesh(2, 2, ["cpu"] * 4))
    with pytest.raises(ValueError, match="int8-cp"):
        TTSEngine(cfg, quantize="int8", mesh=pmesh.make_mesh(1, 2,
                                                            ["cpu"] * 2))


def test_engine_one_rank_mesh_equals_no_mesh():
    """A one-rank mesh issues no collective and keeps K2 (its plain
    version here): int8-cp codes and audio equal to the engine without a
    mesh; a pre-quantized talker is served dense on a mesh, as in JAX."""
    cfg = pconfig.tiny_tts_config(max_tokens=6)
    params = tweights.init_random_params(cfg, seed=1, dtype=torch.float32)
    mesh = pmesh.make_mesh(1, 1, ["cpu"])
    a = TTSEngine(cfg, params=params, dtype=torch.float32, device="cpu",
                  quantize="int8-cp").synthesize("one rank", seed=2)
    eng = TTSEngine(cfg, params=params, dtype=torch.float32,
                    quantize="int8-cp", mesh=mesh)
    b = eng.synthesize("one rank", seed=2)
    np.testing.assert_array_equal(a.codes, b.codes)
    np.testing.assert_array_equal(a.audio_int16, b.audio_int16)
    from qwen3_tts_tpu_torch.ops import quant
    pre = dict(params, talker=quant.quantize_talker(params["talker"]))
    dense = TTSEngine(cfg, params=pre, dtype=torch.float32, mesh=mesh)
    assert not quant.is_quantized(dense.params["talker"])


def test_cli_tp2_writes_a_wav_from_rank_0(tmp_path):
    """`--tp 2 --device cpu --tiny`: the command starts its two gloo
    ranks, rank 0 prints and writes a WAV of n_tokens * 1920 samples."""
    out = tmp_path / "tp2.wav"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "qwen3_tts_tpu_torch.cli", "ab cd", "--tiny",
         "--device", "cpu", "--dtype", "float32", "--tp", "2",
         "--max_tokens", "6", "--output", str(out)],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.count("Text: 'ab cd'") == 1, res.stdout
    assert "Mesh: tp=2 over ['cpu', 'cpu']" in res.stdout
    n = int(res.stdout.split(" tokens,")[0].split()[-1])
    with wave.open(str(out)) as w:
        assert w.getnframes() == n * 1920 and w.getframerate() == 24000


def test_cli_tp_refuses_int8_and_missing_cards(capsys):
    assert cli.main(["ab", "--tiny", "--device", "cpu", "--tp", "1",
                     "--quantize", "int8"]) == 1
    assert "int8-cp" in capsys.readouterr().err
    if torch.cuda.device_count() < 4:
        assert cli.main(["ab", "--tiny", "--tp", "4"]) == 1
        assert "need 4 devices" in capsys.readouterr().err


def test_cli_tp_starts_its_ranks_on_the_first_cards(monkeypatch):
    """`--tp 2` on a host of four cards starts two ranks (on cuda:0 and
    cuda:1); the cards past the first two are not the ranks' concern."""
    started = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(cli, "_run_ranks",
                        lambda n, argv: started.append(n) or 0)
    assert cli.main(["ab", "--tiny", "--tp", "2"]) == 0
    assert started == [2]

