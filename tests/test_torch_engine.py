"""TTSEngine.synthesize and the CLI of the port, on the CPU at tiny
geometry:

1. More codes than one vocoder window (256 tokens) render through
   synthesize_exact's left-context chunks, as in the JAX package.
2. Weights that are already int8 (quant.quantize_talker,
   quantize_code_predictor) are kept, never quantized again, and
   ``quantize`` reports the state as the JAX engine does.
3. The CLI's defaults are the JAX CLI's: bf16 (``--quantize none``), with
   int8 a choice; ``--streaming`` streams and prints the first-audio time.
4. The device busy time of tools/bench_e2e counts overlapping kernels
   once; its host launch time adds the launch calls' CPU time only.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qwen3_tts_tpu import config as C
from qwen3_tts_tpu.io import weights as jweights
from qwen3_tts_tpu.models import vocoder as jvoc
from qwen3_tts_tpu_torch import cli
from qwen3_tts_tpu_torch import config as pconfig
from qwen3_tts_tpu_torch.engine import engine as tengine
from qwen3_tts_tpu_torch.io import weights as tweights
from qwen3_tts_tpu_torch.models import vocoder as tvoc
from qwen3_tts_tpu_torch.ops import quant as tquant

torch.set_num_threads(1)


def test_synthesize_refuses_more_than_one_vocoder_window(monkeypatch):
    """300 codes, more than one vocoder window holds, are no longer
    refused: they render through synthesize_exact's left-context chunks.
    The engine's int16 audio is the port's float synthesize_exact
    converted, and that is JAX's synthesize_exact on the same codes and
    weights within f32 atol 1e-4 (convolutions in another order)."""
    jcfg = C.tiny_tts_config(max_tokens=300)
    jp = jweights.init_random_params(jcfg, seed=4, dtype=jnp.float32)
    params = tweights.init_random_params(
        pconfig.tiny_tts_config(max_tokens=300), seed=0,
        dtype=torch.float32, device="cpu")
    params["vocoder"] = tweights.from_jax_numpy(
        {"vocoder": jax.tree.map(np.asarray, jp["vocoder"])})["vocoder"]
    eng = tengine.TTSEngine(pconfig.tiny_tts_config(max_tokens=300),
                            params=params, device="cpu")
    codes = np.random.default_rng(3).integers(
        0, 2048, (300, 16)).astype(np.int32)

    def run_steps(tp, cpp, state, cfg, budget):
        # a decode that ran to its 300-token budget without an EOS
        state.codes[0, :budget] = torch.from_numpy(codes[:budget])
        return dataclasses.replace(
            state, n_codes=torch.full_like(state.n_codes, budget))
    monkeypatch.setattr(tengine.gen, "run_steps", run_steps)
    res = eng.synthesize("Привет", seed=0)
    assert res.n_tokens == 300 and len(res.audio_int16) == 300 * 1920
    np.testing.assert_array_equal(res.codes, codes)
    vp = eng.vocoder.weights()
    mine = tvoc.synthesize_exact(
        lambda ch: tvoc.decode(vp, ch, eng.cfg.vocoder), codes,
        device="cpu")
    np.testing.assert_array_equal(res.audio_int16, tvoc.to_int16(mine))
    want = jvoc.synthesize_exact(
        jax.jit(lambda ch: jvoc.decode(jp["vocoder"], ch, jcfg.vocoder)),
        codes)
    np.testing.assert_allclose(mine, want, rtol=0, atol=1e-4)


PRE = pconfig.tiny_tts_config(max_tokens=8)


@pytest.fixture(scope="module")
def prequant():
    """Dense tiny weights, their int8 halves, and the codes of the engine
    that quantizes the dense tree itself (quantize="int8")."""
    dense = tweights.init_random_params(PRE, seed=2, dtype=torch.float32,
                                        device="cpu")
    halves = {"talker": tquant.quantize_talker(dense["talker"]),
              "code_predictor": tquant.quantize_code_predictor(
                  dense["code_predictor"])}
    want = tengine.TTSEngine(PRE, params=dense, quantize="int8",
                             device="cpu").synthesize("Привет", seed=0)
    return dense, halves, want.codes


@pytest.mark.parametrize("given,quantize,label", [
    (("talker", "code_predictor"), "int8", "int8"),
    (("talker", "code_predictor"), None, "int8"),
    (("talker",), "int8", "int8"),
    (("code_predictor",), "int8", "int8"),
    (("talker",), None, "int8-talker"),
    (("code_predictor",), None, "int8-cp"),
])
def test_engine_keeps_prequantized_weights(prequant, given, quantize,
                                           label):
    """A pre-quantized talker or code predictor, both or each alone, with
    quantize="int8" or None: the engine runs, never quantizes twice
    (quantize_int8 of a QTensor raises), reports ``quantize`` as the JAX
    engine does (engine.py's pre-quantized branch), and where both halves
    end int8 decodes the codes of quantize="int8" on the dense tree."""
    dense, halves, want = prequant
    params = dict(dense, **{k: halves[k] for k in given})
    eng = tengine.TTSEngine(PRE, params=params, quantize=quantize,
                            device="cpu")
    assert eng.quantize == label
    assert tquant.is_quantized(eng.talker.weights()) == \
        (label != "int8-cp")
    assert tquant.is_quantized(eng.code_predictor.weights()) == \
        (label != "int8-talker")
    res = eng.synthesize("Привет", seed=0)
    assert res.codes.shape == (res.n_tokens, 16) and res.n_tokens > 0
    if label == "int8":
        np.testing.assert_array_equal(res.codes, want)


def test_synthesize_vocodes_one_full_window(monkeypatch):
    """256 codes, the most one window holds, are vocoded."""
    eng = tengine.TTSEngine(pconfig.tiny_tts_config(max_tokens=256),
                            dtype=torch.float32, device="cpu")

    def run_steps(tp, cpp, state, cfg, budget):
        return dataclasses.replace(
            state, n_codes=torch.full_like(state.n_codes, budget))
    monkeypatch.setattr(tengine.gen, "run_steps", run_steps)
    res = eng.synthesize("Привет", seed=0)
    assert res.n_tokens == 256 and len(res.audio_int16) == 256 * 1920


def test_cli_defaults_to_bf16_as_the_jax_cli():
    args = cli.parser().parse_args(["Привет"])
    assert args.quantize == "none"
    assert args.device == "cuda"
    assert args.streaming is False
    assert cli.parser().parse_args(["x", "--streaming"]).streaming is True
    assert cli.parser().parse_args(["x", "--quantize", "int8"]).quantize == \
        "int8"
    with pytest.raises(SystemExit):
        cli.parser().parse_args(["x", "--quantize", "int4"])


def test_cli_streaming_prints_first_audio(monkeypatch, tmp_path, capsys):
    """main(--streaming) streams (the engine is swapped for a tiny one on
    the CPU) and prints the first-audio line."""
    seen = {}
    real = tengine.TTSEngine

    def tiny(**kw):
        seen.update(kw)
        eng = real(pconfig.tiny_tts_config(max_tokens=8), device="cpu",
                   quantize=kw["quantize"], seed=kw["seed"])
        synth = eng.synthesize

        def synthesize(text, **skw):
            seen.update(skw)
            return synth(text, **skw)
        eng.synthesize = synthesize
        return eng
    monkeypatch.setattr(tengine, "TTSEngine", tiny)
    out = tmp_path / "x.wav"
    assert cli.main(["Привет", "--streaming", "--output", str(out),
                     "--device", "cpu"]) == 0
    assert seen["streaming"] is True and seen["quantize"] is None
    lines = capsys.readouterr().out.splitlines()
    assert any(line.startswith("First audio: ") and line.endswith("s")
               for line in lines), lines
    assert out.stat().st_size > 44


def test_device_busy_counts_overlapping_kernels_once():
    """tools/bench_e2e's device busy time is the union of the kernels'
    intervals: kernels that overlap (dependent launch) count once, host
    events not at all; their sum counts each overlap twice."""
    from types import SimpleNamespace as NS

    from qwen3_tts_tpu_torch.tools.bench_e2e import (device_busy_ms,
                                                     device_sum_ms)

    def ev(dev, start, end):
        return NS(device_type=f"DeviceType.{dev}",
                  time_range=NS(start=start, end=end))
    prof = NS(events=lambda: [ev("CUDA", 0, 10), ev("CUDA", 5, 12),
                              ev("CPU", 0, 100), ev("CUDA", 20, 25),
                              ev("CUDA", 21, 22)])
    assert device_busy_ms(prof) == pytest.approx((12 + 5) / 1e3)
    assert device_sum_ms(prof) == pytest.approx((10 + 7 + 5 + 1) / 1e3)


def test_launch_host_ms_sums_kernel_launch_calls():
    """tools/bench_e2e's host launch time adds the CPU time of the CUDA
    runtime's launch calls (plain and extended), and of nothing else."""
    from types import SimpleNamespace as NS

    from qwen3_tts_tpu_torch.tools.bench_e2e import launch_host_ms

    prof = NS(key_averages=lambda: [
        NS(key="cudaLaunchKernel", cpu_time_total=5000.0),
        NS(key="cudaLaunchKernelExC", cpu_time_total=2500.0),
        NS(key="cudaMemcpyAsync", cpu_time_total=900.0),
        NS(key="aten::mul", cpu_time_total=700.0)])
    assert launch_host_ms(prof) == pytest.approx(7.5)


def test_launch_calls_split_by_launch_kind():
    """tools/bench_e2e's launch_calls gives each launch call (plain and
    extended) its calls per token and host us a call, and skips other
    runtime calls and launch kinds that made no call."""
    from types import SimpleNamespace as NS

    from qwen3_tts_tpu_torch.tools.bench_e2e import launch_calls

    prof = NS(key_averages=lambda: [
        NS(key="cudaLaunchKernel", count=40, cpu_time_total=200.0),
        NS(key="cudaLaunchKernelExC", count=10, cpu_time_total=45.0),
        NS(key="cudaLaunchCooperativeKernel", count=0, cpu_time_total=0.0),
        NS(key="cudaMemcpyAsync", count=3, cpu_time_total=60.0)])
    got = launch_calls(prof, 4)
    assert set(got) == {"cudaLaunchKernel", "cudaLaunchKernelExC"}
    assert got["cudaLaunchKernel"] == pytest.approx(
        {"per_token": 10.0, "host_us_a_call": 5.0})
    assert got["cudaLaunchKernelExC"] == pytest.approx(
        {"per_token": 2.5, "host_us_a_call": 4.5})
