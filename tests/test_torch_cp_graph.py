"""The code predictor's prelude (models/code_predictor._prelude: the
2-token prefill, lm_head 0 and the group-1 draw) and the rule that
replays it as a CUDA graph, on the CPU at tiny geometry: which calls
take the graph, the counters of each way, the loop's ``graph_steps`` and
the batcher's ``cp_graph`` attribute and ``cp_graph_steps`` counter.
The graph itself runs only on a card (tests/test_torch_cuda.py)."""

import time

import numpy as np
import pytest
import torch

from qwen3_tts_tpu_torch import config as pconfig
from qwen3_tts_tpu_torch.engine import generate as gen
from qwen3_tts_tpu_torch.io import weights as tweights
from qwen3_tts_tpu_torch.models import code_predictor as tcp
from qwen3_tts_tpu_torch.ops import quant
from qwen3_tts_tpu_torch.ops import sampling as tsmp
from qwen3_tts_tpu_torch.serve import batching as tbatching
from qwen3_tts_tpu_torch.utils import profiling

torch.set_num_threads(1)

CFG = pconfig.tiny_tts_config(max_tokens=12)


@pytest.fixture(scope="module")
def params():
    return tweights.init_random_params(CFG, seed=0, dtype=torch.float32)


def _cp(params, int8):
    cp = params["code_predictor"]
    return quant.quantize_code_predictor(cp) if int8 else cp


def _inputs(params, B, seed=0):
    rng = np.random.default_rng(seed)
    hidden = torch.from_numpy(rng.standard_normal(
        (B, CFG.code_predictor.hidden_size)).astype(np.float32))
    c0 = params["talker"]["codec_embedding"][
        torch.from_numpy(rng.integers(0, 2048, (B,)))]
    seeds = tsmp.token_seeds(tsmp.batch_keys(seed, B),
                             torch.zeros(B, dtype=torch.int32))[:, 1:]
    return hidden, c0, seeds


def _counts():
    c = profiling.snapshot()["counters"]
    return tuple(c.get(k, 0) for k in ("cp_eager_calls", "cp_graph_replays",
                                       "cp_graph_captures"))


@pytest.mark.parametrize("int8", [True, False], ids=["int8", "dense"])
@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_a_cpu_call_runs_the_prelude_eagerly_and_counts_it(params, int8,
                                                          temperature):
    """On a CPU tensor predict_codes runs the eager prelude, counts one
    eager call and no replay or capture, and its codes are the eager
    prelude's followed by the steps after it."""
    cp = _cp(params, int8)
    scfg = pconfig.SamplingConfig(cp_temperature=temperature)
    hidden, c0, seeds = _inputs(params, 3)
    before = _counts()
    got = tcp.predict_codes(cp, hidden, c0, seeds, CFG.code_predictor, scfg)
    eager, replays, captures = _counts()
    assert (eager - before[0], replays, captures) == (1, before[1],
                                                      before[2])
    assert got.shape == (3, 15) and got.dtype == torch.int32
    fused = tcp._fused_kernel_ok(cp, 3)
    assert fused == int8
    parts = tcp._prelude(cp, hidden, c0, seeds, CFG.code_predictor, scfg,
                         rope=fused)
    assert (parts[3] is not None) == fused
    assert parts[0].dtype == torch.int32
    assert torch.equal(got[:, 0], parts[0])
    assert torch.equal(got, tcp._decode(cp, *parts, CFG.code_predictor,
                                        scfg))


@pytest.mark.parametrize("device,tp,graphed", [
    ("cuda", False, True), ("cuda", True, False), ("cpu", False, False),
    ("cpu", True, False)])
def test_only_a_card_off_a_tp_mesh_takes_the_graph(monkeypatch, device, tp,
                                                   graphed):
    """The rule reads the device and the tp mesh alone: a tp mesh gathers
    inside the prelude, and a collective is not captured."""
    monkeypatch.setattr(tcp, "tp_active", lambda mesh: tp)
    assert tcp._graphed(torch.device(device), mesh=object()) == graphed


def test_a_tp_call_on_the_cpu_is_eager(params, monkeypatch):
    """With the tp mesh reported active, the call counts as eager and
    takes the per-step path after the prelude (K2 holds whole heads)."""
    monkeypatch.setattr(tcp, "tp_active", lambda mesh: True)
    cp = _cp(params, True)
    hidden, c0, seeds = _inputs(params, 2, seed=4)
    before = _counts()
    tcp.predict_codes(cp, hidden, c0, seeds, CFG.code_predictor,
                      CFG.sampling)
    assert _counts() == (before[0] + 1, before[1], before[2])


def _state(params, B=2):
    cfg = CFG
    prefix = torch.randn((B, 6, cfg.talker.hidden_size),
                         generator=torch.Generator().manual_seed(1))
    return gen.init_state(params["talker"], prefix,
                          torch.full((B,), 6, dtype=torch.int32),
                          torch.full((B,), 4, dtype=torch.int32),
                          tsmp.batch_keys(3, B), cfg)


def _replaying(monkeypatch):
    """The rule reporting the graph taken, as on a card, with the prelude
    still run eagerly (no graph is captured on the CPU)."""
    monkeypatch.setattr(tcp, "_graphed", lambda device, mesh=None: True)

    def eager(params, hidden, c0, seeds, cfg, scfg, mesh=None):
        rope = tcp._fused_kernel_ok(params, hidden.shape[0], mesh)
        return tcp._decode(params, *tcp._prelude(
            params, hidden, c0, seeds, cfg, scfg, mesh, rope=rope), cfg,
            scfg, mesh)
    monkeypatch.setattr(tcp, "predict_codes", eager)


@pytest.mark.parametrize("replay", [False, True],
                         ids=["eager", "replaying"])
def test_run_steps_reports_its_graph_steps(params, monkeypatch, replay):
    """``graph_steps`` is the steps whose prelude replayed a graph: none
    on the CPU, every step where the rule takes the graph."""
    if replay:
        _replaying(monkeypatch)
    stats = {}
    gen.run_steps(params["talker"], params["code_predictor"],
                  _state(params), CFG, 5, stats=stats)
    assert stats["steps"] == 5
    assert stats["graph_steps"] == (5 if replay else 0)


def _ids(text, n=16):
    raw = list(text.encode("utf-8"))[:n]
    arr = np.zeros(n, np.int32)
    arr[:len(raw)] = raw
    return arr, len(raw)


@pytest.mark.parametrize("replay", [False, True],
                         ids=["eager", "replaying"])
def test_the_dispatch_span_carries_cp_graph(params, monkeypatch, replay):
    """Each ``dispatch`` span carries ``cp_graph`` (0 on the CPU) beside
    ``steps``, and the registry counts ``cp_graph_steps``, which the
    batcher's counters show."""
    if replay:
        _replaying(monkeypatch)
    t = time.perf_counter_ns()
    b = tbatching.ContinuousBatcher(CFG, params, batch_size=2,
                                    decode_chunk=4, dtype=torch.float32,
                                    device="cpu")
    futs = [b.submit(*_ids(s), seed=i) for i, s in enumerate(["ab", "cde"])]
    for _ in range(100):
        if all(f.done() for f in futs):
            break
        b.step()
    for f in futs:
        f.result(timeout=1)
    ds = [e for e in profiling.entries()
          if e.start >= t and e.name == "dispatch"]
    assert ds
    for d in ds:
        assert d.attrs["cp_graph"] == (d.attrs["steps"] if replay else 0)
    grew = b.occupancy()["counters"]
    assert grew["cp_graph_steps"] == sum(d.attrs["cp_graph"] for d in ds)
    assert grew["cp_graph_steps"] == (grew["loop_steps"] if replay else 0)
