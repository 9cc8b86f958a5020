"""TTSEngine.synthesize and the CLI of the port, on the CPU at tiny
geometry:

1. synthesize refuses more codes than one vocoder window (256 tokens), as
   synthesize_batch and the batcher do: the JAX package renders longer
   utterances with its chunked synthesize_exact, which the port does not
   have yet, so one long window would give other audio.
2. The CLI's defaults are the JAX CLI's: bf16 (``--quantize none``), with
   int8 a choice.
3. The device busy time of tools/bench_e2e counts overlapping kernels
   once; its host launch time adds the launch calls' CPU time only.
"""

import dataclasses

import pytest
import torch

from qwen3_tts_tpu_torch import cli
from qwen3_tts_tpu_torch import config as pconfig
from qwen3_tts_tpu_torch.engine import engine as tengine

torch.set_num_threads(1)


def test_synthesize_refuses_more_than_one_vocoder_window(monkeypatch):
    eng = tengine.TTSEngine(pconfig.tiny_tts_config(max_tokens=300),
                            dtype=torch.float32, device="cpu")

    def run_steps(tp, cpp, state, cfg, budget):
        # a decode that ran to its 300-token budget without an EOS
        return dataclasses.replace(
            state, n_codes=torch.full_like(state.n_codes, budget))
    monkeypatch.setattr(tengine.gen, "run_steps", run_steps)
    with pytest.raises(NotImplementedError, match="vocoder window"):
        eng.synthesize("Привет", seed=0)


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
    assert cli.parser().parse_args(["x", "--quantize", "int8"]).quantize == \
        "int8"
    with pytest.raises(SystemExit):
        cli.parser().parse_args(["x", "--quantize", "int4"])


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
