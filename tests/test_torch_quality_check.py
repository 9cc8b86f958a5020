"""The port's int8 quality dossier (qwen3_tts_tpu_torch/tools/
quality_check.py) on the CPU at the JAX test's tiny dossier
(tests/test_quality_check.py: max_tokens 10, 6 hidden steps, one text),
with every bound of that test held on the port; the port's f32 and bf16
trajectories against the JAX tool's on the same numpy weights; and a
short run of the serving soak (qwen3_tts_tpu_torch/tools/soak_daemon.py)
dense and paged.

At tiny geometry with random weights free-running agreement is near 0 by
construction (random logits are near ties), so the bounds are the ones
that stay meaningful: the teacher-forced hidden drift of the int8 talker
(tf_cos_min), and int8-cp leaving the dense talker exact.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qwen3_tts_tpu import config as C
from qwen3_tts_tpu.io import weights as jweights
from qwen3_tts_tpu_torch import config as pconfig
from qwen3_tts_tpu_torch.io import weights as tweights
from qwen3_tts_tpu_torch.tools import quality_check as qc
from tools import quality_check as jqc

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXT = "проверка качества quant check"


def _soak_cmd(paged: bool) -> list:
    return ([sys.executable, "-m", "qwen3_tts_tpu_torch.tools.soak_daemon",
             "--tiny", "--device", "cpu", "--seconds", "3", "--batch", "2",
             "--decode_chunk", "4"] + (["--paged"] if paged else []))


@pytest.fixture(scope="module", autouse=True)
def soaks():
    """Both soak runs, started before this file's first test so that they
    run beside the dossier."""
    # the byte tokenizer, which the tool falls back to here anyway,
    # without the transformers import it would try first
    env = dict(os.environ, OMP_NUM_THREADS="1", QWEN3_TTS_TOKENIZER="byte")
    procs = {paged: subprocess.Popen(
        _soak_cmd(paged), cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for paged in (False, True)}
    yield procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def dossier():
    cfg = qc.greedy_config(pconfig.tiny_tts_config(max_tokens=10))
    params = tweights.load_params(None, cfg, torch.bfloat16, seed=0)
    return qc.run_dossier(cfg, params, ["int8", "int8-cp"], texts=[TEXT],
                          seed=0, n_hidden_steps=6, device="cpu")


def test_int8_teacher_forced_hidden_drift_bounded(dossier):
    a = dossier["int8"]
    assert a["tf_cos_min"] >= 0.999, a
    assert a["hidden_cos_min"] >= 0.999, a


def test_int8_cp_leaves_talker_exact(dossier):
    a = dossier["int8-cp"]
    assert a["tf_cos_min"] >= 1.0 - 1e-9, a
    assert a["tf_code0_agree"] == 1.0, a


def test_greedy_config_is_deterministic(dossier):
    assert dossier["int8"]["len_match"]
    assert dossier["int8-cp"]["len_match"]


def test_metrics_ranges(dossier):
    for v in ("int8", "int8-cp"):
        a = dossier[v]
        for k in ("tf_code0_agree", "tf_row_agree", "code0_agree",
                  "row_agree", "prefix_frac", "int16_match"):
            assert 0.0 <= a[k] <= 1.0, (v, k, a[k])
        assert set(qc.SUMMARY_KEYS) <= set(a)


def test_snr_db_basics():
    a = (np.sin(np.linspace(0, 20, 2000)) * 20000).astype(np.int16)
    assert qc.snr_db(a, a) == float("inf")
    noisy = (a + np.random.default_rng(0)
             .integers(-200, 200, a.shape)).astype(np.int16)
    assert 30.0 < qc.snr_db(a, noisy) < 60.0
    assert qc.snr_db(a, noisy) == jqc.snr_db(a, noisy)
    # length mismatch: compared over the common prefix
    assert qc.snr_db(a, a[:500]) == float("inf")


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items() if k != "layers_list"}
    return np.asarray(tree)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def trajectories(request):
    """The hidden and teacher-forced trajectories of the JAX tool and of
    the port on the same weights (the JAX ones, as numpy), in f32 and in
    bf16; the port's teacher-forced run is forced with JAX's codes."""
    jdt, tdt = ((jnp.float32, torch.float32) if request.param == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    jcfg = jqc.greedy_config(C.tiny_tts_config(max_tokens=10))
    jp = jweights.load_params(None, jcfg, jdt, seed=0)
    jeng = jqc.build_engine(jcfg, jp, None)
    jh, jcodes, jn = jqc.hidden_trajectory(jeng, TEXT, 0, 6)
    jcodes = np.asarray(jcodes)[:jn]
    jth, jrows = jqc.teacher_forced_trajectory(jeng, TEXT, 0, jcodes)
    cfg = qc.greedy_config(pconfig.tiny_tts_config(max_tokens=10))
    params = tweights.from_jax_numpy(_np(jp))
    eng = qc.build_engine(cfg, params, None, "cpu", dtype=tdt)
    h, codes, n = qc.hidden_trajectory(eng, TEXT, 0, 6)
    th, rows = qc.teacher_forced_trajectory(eng, TEXT, 0, jcodes)
    return request.param, (jh, jcodes, jth, np.asarray(jrows)), (
        h, codes[:n], th, rows)


def test_hidden_trajectory_matches_jax_tool(trajectories):
    """f32: the same codes and hiddens within f32 noise (atol 1e-5). bf16:
    the same rows up to the first one where a code predictor group
    differs, and the hiddens within the slice tests' tolerance
    (tests/test_torch_slice.py: rtol 5e-2, atol 2e-2) up to and including
    that step; past it the feedback differs. XLA on the CPU keeps some
    bf16 intermediates in f32 (its excess precision), so a near tie among
    the code predictor's bf16 logits may go the other way."""
    dtype, (jh, jcodes, _, _), (h, codes, _, _) = trajectories
    assert len(codes) == len(jcodes) >= 1
    if dtype == "float32":
        np.testing.assert_array_equal(codes, jcodes)
        np.testing.assert_allclose(h, jh, rtol=0, atol=1e-5)
        return
    same = (codes == jcodes).all(axis=1)
    k = int(np.argmin(same)) if not same.all() else len(same)
    assert k >= 1 and (codes[:, 0][:k + 1] == jcodes[:, 0][:k + 1]).all()
    np.testing.assert_allclose(h[:k + 1], jh[:k + 1], rtol=5e-2, atol=2e-2)


def test_teacher_forced_trajectory_matches_jax_tool(trajectories):
    """Forced with JAX's codes, every step sees JAX's context. f32: the
    same chosen rows and hiddens within 1e-5. bf16: the same code_0 at
    every step (the talker's choice) and hiddens within the slice tests'
    tolerance at every step; a code predictor group may differ at a near
    tie (above)."""
    dtype, (_, _, jth, jrows), (_, _, th, rows) = trajectories
    assert rows.shape == jrows.shape and len(rows) >= 1
    if dtype == "float32":
        np.testing.assert_array_equal(rows, jrows)
        np.testing.assert_allclose(th, jth, rtol=0, atol=1e-5)
        return
    np.testing.assert_array_equal(rows[:, 0], jrows[:, 0])
    np.testing.assert_allclose(th, jth, rtol=5e-2, atol=2e-2)


def test_quality_check_main_prints_the_jax_keys(capsys):
    """``--tiny --device cpu``: one JSON line on stdout with the JAX
    tool's keys."""
    assert qc.main(["--tiny", "--device", "cpu", "--max_tokens", "6",
                    "--hidden_steps", "3", "--texts", "ab",
                    "--variants", "int8-cp"]) == 0
    import json
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert (out["geometry"], out["weights"], out["n_texts"]) == (
        "tiny", "random", 1)
    assert set(out["int8-cp"]) == set(qc.SUMMARY_KEYS)


@pytest.mark.parametrize("paged", [False, True])
def test_soak_tool_exits_healthy(soaks, paged):
    """``soak_daemon --tiny --device cpu --seconds 3 --batch 2``, dense and
    paged: every Future resolved, every slot and page free, no failure."""
    out, err = soaks[paged].communicate(timeout=240)
    assert soaks[paged].returncode == 0, out[-2000:] + err[-3000:]
    import json
    res = json.loads(out.strip().splitlines()[-1])
    assert res["healthy"] and res["pages_recovered"] and res["slots_free"]
    assert res["ok"] >= 1 and res["errors"] == 0
    assert res["step_failures"] == 0
