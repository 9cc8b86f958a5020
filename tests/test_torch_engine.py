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
5. ``quantize="int8-cp"``: the labels and weights of the JAX engine on
   every pre-quantized case, and its greedy codes.
6. The CLI's other flags parse to the JAX CLI's defaults; ``--tiny`` runs
   on the CPU, ``--profile`` writes a trace, ``--long`` goes through
   synthesize_long; a request error and zero tokens return 1.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qwen3_tts_tpu import cli as jcli
from qwen3_tts_tpu import config as C
from qwen3_tts_tpu.engine import engine as jengine
from qwen3_tts_tpu.io import weights as jweights
from qwen3_tts_tpu.models import code_predictor as jcp
from qwen3_tts_tpu.models import vocoder as jvoc
from qwen3_tts_tpu.ops import quant as jquant
from qwen3_tts_tpu.ops.pallas import cp_decode as jcp_kernel
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

    def run_steps(tp, cpp, state, cfg, budget, mesh=None):
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
    ((), "int8-cp", "int8-cp"),
    (("talker", "code_predictor"), "int8-cp", "int8-cp"),
    (("talker",), "int8-cp", "int8-cp"),
    (("code_predictor",), "int8-cp", "int8-cp"),
])
def test_engine_keeps_prequantized_weights(prequant, given, quantize,
                                           label):
    """A pre-quantized talker or code predictor, both or each alone, with
    quantize="int8" or None: the engine runs, never quantizes twice
    (quantize_int8 of a QTensor raises), reports ``quantize`` as the JAX
    engine does (engine.py's pre-quantized branch), and where both halves
    end int8 decodes the codes of quantize="int8" on the dense tree.
    "int8-cp" makes an int8 talker dense and quantizes a dense code
    predictor, as the JAX engine does."""
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

    def run_steps(tp, cpp, state, cfg, budget, mesh=None):
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


# the pre-quantized halves of test_engine_keeps_prequantized_weights,
# with quantize="int8-cp"
CP_CASES = [(), ("talker", "code_predictor"), ("talker",),
            ("code_predictor",)]


def _jnp_tree(tree):
    """JAX params -> numpy, each QTensor as (q, scale)."""
    if isinstance(tree, dict):
        return {k: _jnp_tree(v) for k, v in tree.items()
                if k != "layers_list"}
    if isinstance(tree, jquant.QTensor):
        return (np.asarray(tree.q), np.asarray(tree.scale))
    return np.asarray(tree)


@pytest.mark.parametrize("given", CP_CASES,
                         ids=["dense", "both", "talker", "cp"])
def test_int8_cp_labels_and_weights_match_jax(given):
    """The JAX engine and the port on the same (pre-quantized) weights
    with quantize="int8-cp": the same label, a dense talker whose q/k/v
    and gate/up weights (dequantized where they came int8) and codec head
    equal JAX's, and the same int8 code predictor."""
    jcfg = C.tiny_tts_config(max_tokens=4)
    base = jweights.init_random_params(jcfg, seed=3, dtype=jnp.float32)
    jp = dict(base)
    if "talker" in given:
        jp["talker"] = jquant.quantize_talker(base["talker"])
    if "code_predictor" in given:
        jp["code_predictor"] = jquant.quantize_code_predictor(
            base["code_predictor"])
    jeng = jengine.TTSEngine(jcfg, params=jp, dtype=jnp.float32,
                             quantize="int8-cp")
    eng = tengine.TTSEngine(pconfig.tiny_tts_config(max_tokens=4),
                            params=tweights.from_jax_numpy(_jnp_tree(jp)),
                            dtype=torch.float32, quantize="int8-cp",
                            device="cpu")
    assert eng.quantize == jeng.quantize == "int8-cp"
    tl, jl = eng.talker.weights()["layers"], jeng.params["talker"]["layers"]
    assert "qkv_proj" not in tl
    for name in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                 "up_proj", "down_proj"):
        assert tl[name].dtype == torch.float32
        np.testing.assert_array_equal(tl[name].numpy(),
                                      np.asarray(jl[name]), err_msg=name)
    np.testing.assert_array_equal(
        eng.talker.weights()["codec_head"].numpy(),
        np.asarray(jeng.params["talker"]["codec_head"]))
    # a code predictor that each engine quantizes at init: XLA may divide
    # amax by 127 as a product with its reciprocal, so a scale may differ
    # by 1 ulp, and a value on a rounding tie by one step of q
    pre = "code_predictor" in given
    tc, jc = eng.code_predictor.weights(), jeng.params["code_predictor"]
    for name, t, j in [(n, tc["layers"][n], jc["layers"][n])
                       for n in ("q_proj", "down_proj")] + [
                           ("lm_heads", tc["lm_heads"], jc["lm_heads"])]:
        dq = np.abs(t.q.numpy().astype(np.int32)
                    - np.asarray(j.q).astype(np.int32))
        assert dq.max() <= (0 if pre else 1), name
        assert (dq > 0).mean() <= (0 if pre else 1e-5), name
        np.testing.assert_allclose(t.scale.numpy(), np.asarray(j.scale),
                                   rtol=0 if pre else 2.4e-7, atol=0,
                                   err_msg=name)


def test_int8_cp_greedy_codes_match_jax(monkeypatch):
    """f32, greedy, one int8 code predictor (quantized once, by the JAX
    package) for both int8-cp engines: equal codes over 8 tokens, the
    port's code predictor on K2's and K1's plain versions, its talker
    dense; the JAX code predictor forced through its TPU kernel in
    interpret mode, as tests/test_torch_slice.py's int8 step is. The
    weight seed is 0: at that test's INT8_SEED (2) a greedy choice at
    token 6 is a near tie that XLA's default excess bf16 precision flips
    on the CPU (with --xla_allow_excess_precision=false, seeds 0 and 2
    both give equal codes)."""
    monkeypatch.setattr(jcp, "_fused_kernel_ok", lambda *a, **k: True)
    monkeypatch.setattr(
        jcp_kernel, "cp_decode_steps",
        functools.partial(jcp_kernel.cp_decode_steps, interpret=True))
    greedy = C.SamplingConfig(temperature=0.0, repetition_penalty=1.0,
                              cp_temperature=0.0)
    jcfg = dataclasses.replace(C.tiny_tts_config(max_tokens=8),
                               sampling=greedy)
    pcfg = dataclasses.replace(
        pconfig.tiny_tts_config(max_tokens=8),
        sampling=pconfig.SamplingConfig(**dataclasses.asdict(greedy)))
    jp = dict(jweights.init_random_params(jcfg, seed=0, dtype=jnp.float32))
    jp["code_predictor"] = jquant.quantize_code_predictor(
        jp["code_predictor"])
    jeng = jengine.TTSEngine(jcfg, params=jp, dtype=jnp.float32,
                             quantize="int8-cp")
    want = jeng.synthesize("Привет, мир!", seed=0)
    eng = tengine.TTSEngine(pcfg, params=tweights.from_jax_numpy(
        _jnp_tree(jp)), dtype=torch.float32, quantize="int8-cp",
                            device="cpu")
    assert eng.quantize == jeng.quantize == "int8-cp"
    got = eng.synthesize("Привет, мир!", seed=0)
    assert got.n_tokens == want.n_tokens == 8
    np.testing.assert_array_equal(got.codes, np.asarray(want.codes))


def test_cli_flags_parse_to_the_jax_defaults():
    mine = vars(cli.parser().parse_args([]))
    theirs = vars(jcli.build_parser().parse_args([]))
    for flag in ("text", "text_flag", "output", "language", "dtype", "seed",
                 "max_tokens", "temperature", "top_k", "tiny", "streaming",
                 "long", "prompt_dir", "profile"):
        assert mine[flag] == theirs[flag], flag
    assert mine["quantize"] == "none" and theirs["quantize"] is None
    args = cli.parser().parse_args(
        ["--text", "t", "--dtype", "float32", "--temperature", "0.5",
         "--top_k", "7", "--tiny", "--long", "--prompt_dir", "p",
         "--profile", "d", "--quantize", "int8-cp"])
    assert (args.text_flag, args.dtype, args.temperature, args.top_k,
            args.tiny, args.long, args.prompt_dir, args.profile,
            args.quantize) == ("t", "float32", 0.5, 7, True, True, "p",
                               "d", "int8-cp")
    with pytest.raises(SystemExit):
        cli.parser().parse_args(["--dtype", "float16"])


def test_cli_tiny_profile_and_long(tmp_path, monkeypatch, capsys):
    """--tiny on the CPU writes the WAV and, under --profile, a trace;
    --long goes through synthesize_long (4 pieces here) with the cap
    --max_tokens sets; --streaming with it prints JAX's note."""
    out, prof = tmp_path / "x.wav", tmp_path / "prof"
    assert cli.main(["ab", "--tiny", "--device", "cpu", "--output",
                     str(out), "--profile", str(prof)]) == 0
    assert out.stat().st_size > 44
    assert any(f.endswith(".json") for f in os.listdir(prof))
    calls = []
    real = tengine.TTSEngine.synthesize_long

    def spy(self, text, **kw):
        calls.append((self.cfg.max_tokens, kw))
        return real(self, text, **kw)
    monkeypatch.setattr(tengine.TTSEngine, "synthesize_long", spy)
    out2 = tmp_path / "y.wav"
    assert cli.main(["ab cd ef gh", "--tiny", "--device", "cpu", "--long",
                     "--streaming", "--max_tokens", "8", "--temperature",
                     "0", "--output", str(out2)]) == 0
    assert calls and calls[0][0] == 8 and calls[0][1]["prompt_dir"] is None
    assert out2.stat().st_size > 44
    assert "note: --long" in capsys.readouterr().out


def test_cli_errors_return_one(tmp_path, monkeypatch, capsys):
    assert cli.main(["a", "--tiny", "--device", "cpu", "--prompt_dir",
                     str(tmp_path / "missing")]) == 1
    assert "error: invalid prompt_dir" in capsys.readouterr().err

    def run_steps(tp, cpp, state, cfg, steps, mesh=None):
        return dataclasses.replace(state, done=torch.ones_like(state.done))
    monkeypatch.setattr(tengine.gen, "run_steps", run_steps)
    out = tmp_path / "none.wav"
    assert cli.main(["a", "--tiny", "--device", "cpu", "--output",
                     str(out)]) == 1
    assert "No tokens generated!" in capsys.readouterr().out
    assert not out.exists()
