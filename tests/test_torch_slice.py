"""The PyTorch port's single-request synthesis slice against the JAX
package, on the CPU at tiny geometry.

1. Dense f32, greedy: the port's generate + vocoder.decode equal JAX's.
2. int8: one decode-loop step from the same state, the JAX side running
   the TPU kernels' math (talker_step and cp_decode in interpret mode).
3. The port's TTSEngine.synthesize (int8) end to end.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qwen3_tts_tpu import config as C
from qwen3_tts_tpu.engine import generate as jgen
from qwen3_tts_tpu.io import weights as jweights
from qwen3_tts_tpu.models import code_predictor as jcp
from qwen3_tts_tpu.models import talker as jtk
from qwen3_tts_tpu.models import vocoder as jvoc
from qwen3_tts_tpu.ops import quant as jquant
from qwen3_tts_tpu.ops.pallas import cp_decode as jcp_kernel
from qwen3_tts_tpu.ops.pallas import talker_step as jtalker_kernel
from qwen3_tts_tpu_torch import config as pconfig
from qwen3_tts_tpu_torch.engine import engine as tengine
from qwen3_tts_tpu_torch.engine import generate as tgen
from qwen3_tts_tpu_torch.io import weights as tweights
from qwen3_tts_tpu_torch.models import talker as ttk
from qwen3_tts_tpu_torch.models import vocoder as tvoc
from qwen3_tts_tpu_torch.ops import sampling as tsmp
from qwen3_tts_tpu_torch.ops.kernels import cp_decode as tcp_kernel
from qwen3_tts_tpu_torch.ops.kernels import qmatmul as tqm
from qwen3_tts_tpu_torch.ops.kernels import talker_step as tts_kernel

torch.set_num_threads(1)

GREEDY = C.SamplingConfig(temperature=0.0, repetition_penalty=1.0,
                          cp_temperature=0.0)
CFG = dataclasses.replace(C.tiny_tts_config(max_tokens=8), sampling=GREEDY)
# the port's twin of CFG (tests/test_torch_modules.py holds the configs equal)
PCFG = dataclasses.replace(
    pconfig.tiny_tts_config(max_tokens=8),
    sampling=pconfig.SamplingConfig(**dataclasses.asdict(GREEDY)))
IDS = np.array([10, 20, 30, 40, 50, 0, 0, 0], np.int32)
N_TEXT = 5
INT8_SEED = 2


def _np(tree):
    """JAX params -> numpy, each QTensor as (q, scale)."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items() if k != "layers_list"}
    if isinstance(tree, jquant.QTensor):
        return (np.asarray(tree.q), np.asarray(tree.scale))
    return np.asarray(tree)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def dense():
    jp = jweights.init_random_params(CFG, seed=1, dtype=jnp.float32)
    return jp, tweights.from_jax_numpy(_np(jp))


def _prefixes(jp, tp):
    jpre, jlen = jtk.build_prefix(jp["talker"], jnp.asarray(IDS),
                                  jnp.int32(N_TEXT))
    tpre, tlen = ttk.build_prefix(tp["talker"], _t(IDS), N_TEXT)
    return (jpre[None], jlen[None]), (tpre[None], tlen[None])


def test_dense_greedy_generate_and_vocode_match_jax(dense):
    """Codes and n_codes bit-equal; audio of the f32 vocoder atol 1e-4."""
    jp, tp = dense
    (jpre, jlen), (tpre, tlen) = _prefixes(jp, tp)
    jcodes, jn = jgen.generate(jp["talker"], jp["code_predictor"], jpre,
                               jlen, jnp.asarray([N_TEXT], jnp.int32),
                               jax.random.PRNGKey(0), CFG)
    tcodes, tn = tgen.generate(tp["talker"], tp["code_predictor"], tpre,
                               tlen, torch.tensor([N_TEXT]),
                               tsmp.batch_keys(0, 1), PCFG)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
    n = int(tn[0])
    assert n >= 1
    W = tvoc.voc_bucket(n + 1)
    codes = np.zeros((1, W, 16), np.int32)
    codes[0, :n] = tcodes[0, :n].numpy()
    want = np.asarray(jvoc.decode(jp["vocoder"], jnp.asarray(codes),
                                  CFG.vocoder))
    got = tvoc.decode(tp["vocoder"], _t(codes), PCFG.vocoder).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def _port_state(js):
    return tgen.GenState(
        kv=_t(js.kv), pos=_t(js.pos), hidden=_t(js.hidden),
        ring=_t(js.ring), n_codes=_t(js.n_codes), done=_t(js.done),
        codes=_t(js.codes), n_text=_t(js.n_text), budget=_t(js.budget),
        key=tsmp.batch_keys(0, js.pos.shape[0]))


def test_int8_loop_body_step_matches_jax_kernels(monkeypatch):
    """One int8 decode-loop step from the same state. The JAX side is
    forced through its TPU kernels in interpret mode; the port runs the
    plain versions of K1, K2 and K3. The 16 codes are equal; the hidden
    is held at the talker kernel's tolerance (rtol 5e-2 / atol 2e-2)."""
    monkeypatch.setattr(jtk, "_fused_step_ok", lambda *a, **k: True)
    monkeypatch.setattr(jcp, "_fused_kernel_ok", lambda *a, **k: True)
    monkeypatch.setattr(
        jtalker_kernel, "talker_decode_step_fused",
        functools.partial(jtalker_kernel.talker_decode_step_fused,
                          interpret=True))
    monkeypatch.setattr(
        jcp_kernel, "cp_decode_steps",
        functools.partial(jcp_kernel.cp_decode_steps, interpret=True))
    # Interpreted on the CPU, the JAX kernels run as one XLA program, and
    # XLA's default --xla_allow_excess_precision skips some of their bf16
    # roundings: with it off, cp_decode's logits equal the port's bit for
    # bit; with it on they differ by bf16 ulps. Random heads give
    # near-uniform logits, so the weights are drawn from a seed whose
    # greedy choices are separated by more than that (seed 1 has a top-2
    # gap of 8e-4 at one CP step, which the excess precision flips).
    jp0 = jweights.init_random_params(CFG, seed=INT8_SEED,
                                      dtype=jnp.float32)
    jp = {"talker": jquant.quantize_talker(jp0["talker"]),
          "code_predictor": jquant.quantize_code_predictor(
              jp0["code_predictor"])}
    tp = tweights.from_jax_numpy(_np(jp))
    (jpre, jlen), _ = _prefixes(jp, tp)
    js = jgen.init_state(jp["talker"], jpre, jlen,
                         jnp.asarray([N_TEXT], jnp.int32),
                         jax.random.PRNGKey(0), CFG)
    tstate = _port_state(js)
    pad = jtk.embed_text(jp["talker"], jnp.array([C.TTS_PAD_TOKEN_ID]))[0]
    js1 = jgen._loop_body(js, jp["talker"], jp["code_predictor"], pad, CFG)
    ts1 = tgen._loop_body(tstate, tp["talker"], tp["code_predictor"],
                          _t(pad), PCFG)
    np.testing.assert_array_equal(ts1.codes[0, 0].numpy(),
                                  np.asarray(js1.codes[0, 0]))
    assert int(ts1.n_codes[0]) == int(js1.n_codes[0]) == 1
    np.testing.assert_allclose(ts1.hidden.numpy(), np.asarray(js1.hidden),
                               rtol=5e-2, atol=2e-2)
    p = int(js.pos[0])
    np.testing.assert_allclose(ts1.kv[:, :, 0, p].numpy(),
                               np.asarray(js1.kv[:, :, 0, p]),
                               rtol=2e-2, atol=2e-2)


@pytest.fixture(scope="module")
def engine():
    return tengine.TTSEngine(pconfig.tiny_tts_config(max_tokens=8), seed=0,
                             quantize="int8", device="cpu")


def test_engine_int8_synthesize_on_cpu(engine, tmp_path):
    """Duration math, code range and the WAV file of a non-streaming
    int8 request (plain kernel versions on the CPU)."""
    out = tmp_path / "x.wav"
    res = engine.synthesize("Привет, мир!", seed=0, output=str(out))
    n = res.n_tokens
    assert 0 <= n <= 8
    assert res.codes.shape == (n, 16)
    assert ((res.codes >= 0) & (res.codes < 2048)).all()
    assert res.audio_int16.dtype == np.int16
    assert len(res.audio_int16) == n * C.SAMPLES_PER_TOKEN
    assert out.stat().st_size == 44 + 2 * len(res.audio_int16)
    again = engine.synthesize("Привет, мир!", seed=0)
    np.testing.assert_array_equal(again.codes, res.codes)
    capped = engine.synthesize("Привет, мир!", seed=0, max_tokens=2)
    assert capped.n_tokens <= 2
    assert len(capped.audio_int16) == capped.n_tokens * C.SAMPLES_PER_TOKEN


def test_engine_refuses_what_is_not_ported(engine):
    """Streaming, once refused here, is ported: its pieces give the
    non-streaming codes and audio. Voice cloning, once refused here too,
    is ported: a prompt dir that does not exist is the JAX engine's
    ValueError. Checkpoints, once refused here, are ported: a model dir
    without weights is the JAX engine's FileNotFoundError."""
    pieces = []
    res = engine.synthesize("a", streaming=True, on_chunk=pieces.append)
    want = engine.synthesize("a")
    np.testing.assert_array_equal(res.codes, want.codes)
    np.testing.assert_array_equal(np.concatenate(pieces), want.audio_int16)
    with pytest.raises(ValueError, match="invalid prompt_dir"):
        engine.synthesize("a", prompt_dir="/nonexistent")
    with pytest.raises(FileNotFoundError):
        tengine.TTSEngine(pconfig.tiny_tts_config(), model_dir="x",
                          device="cpu")
    with pytest.raises(ValueError):
        engine.synthesize("a", language="klingon")


def test_kernel_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a CUDA card gets no
    plain-version fallback: the wrappers raise."""
    meta = dict(device="meta")
    x = torch.empty((1, 64), **meta)
    with pytest.raises(ValueError):
        tqm.qmatmul(x, torch.empty((64, 256), dtype=torch.int8, **meta),
                    torch.empty((256,), **meta))
    with pytest.raises(ValueError):
        tts_kernel.talker_decode_step_fused(
            {}, x, torch.zeros((1,), dtype=torch.int32, **meta),
            torch.empty((1, 2, 1, 8, 1, 16), **meta), None, None, eps=1e-6)
    with pytest.raises(ValueError):
        tcp_kernel.cp_decode_steps(
            {}, torch.zeros((1,), dtype=torch.int32, **meta),
            torch.empty((1, 2, 1, 16, 1, 16), **meta), None, None,
            torch.zeros((1,), dtype=torch.int32, **meta), eps=1e-6,
            top_k=50, temperature=0.1, greedy=False)
