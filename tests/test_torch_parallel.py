"""The port's multi-device tier (qwen3_tts_tpu_torch/parallel) on the CPU:
the layout rules without processes (twins of tests/test_sharding.py and
tests/test_multihost.py), then a layer stack's decode step and the int8
code predictor at tp = 2 and tp = 4 over gloo (tests/torch_mesh_worker.py
ranks), against the JAX package's sharded computations on the conftest's
virtual CPU mesh and against the port without a mesh.

Tolerances: the sharded decode adds its o and down products up over the
tp ranks, in another order than one device, in f32: hidden and KV within
atol 1e-5 of both references (their scale is ~0.3). Greedy codes are
compared equal. Every tp rank must hold the same hidden bit for bit (one
all-reduce gives every rank the same sum).
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from qwen3_tts_tpu import config as C
from qwen3_tts_tpu.models import code_predictor as jcp
from qwen3_tts_tpu.models import transformer as jtfm
from qwen3_tts_tpu.ops import quant as jquant
from qwen3_tts_tpu.parallel import mesh as jmesh
from qwen3_tts_tpu_torch import config as pconfig
from qwen3_tts_tpu_torch.io import weights as tweights
from qwen3_tts_tpu_torch.models import code_predictor as tcp
from qwen3_tts_tpu_torch.models import transformer as ttfm
from qwen3_tts_tpu_torch.ops import quant as tquant
from qwen3_tts_tpu_torch.ops import sampling as tsmp
from qwen3_tts_tpu_torch.parallel import mesh as pmesh
from qwen3_tts_tpu_torch.parallel import multihost as mh

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_mesh_worker as W  # noqa: E402

torch.set_num_threads(1)

ATOL = 1e-5


def _cpus(n):
    return ["cpu"] * n


# ---------------------------------------------------------------------------
# layout rules, no processes
# ---------------------------------------------------------------------------

def test_make_mesh_shapes_and_errors():
    m = pmesh.make_mesh(2, 4, _cpus(8))
    assert m.shape == {"dp": 2, "tp": 4}
    assert m.devices.shape == (2, 4)
    assert (m.dp_index, m.tp_index, m.rank) == (0, 0, 0)
    assert m.device == torch.device("cpu")
    assert [d.rank for d in m.devices[1]] == [4, 5, 6, 7]
    with pytest.raises(ValueError, match="need 16 devices, have 8"):
        pmesh.make_mesh(4, 4, _cpus(8))
    # one card may be listed for two ranks (two ranks on one GPU)
    two = pmesh.make_mesh(2, 1, ["cuda:0", "cuda:0"])
    assert [d.device for d in two.devices.flat] == ["cuda:0", "cuda:0"]
    # without a world the default is this process alone, on the card
    assert pmesh.make_mesh(1, 1).device == torch.device("cuda:0")


def test_init_distributed_noop_and_missing_coordinator(monkeypatch):
    monkeypatch.delenv("QWEN3_TTS_COORDINATOR", raising=False)
    monkeypatch.setenv("QWEN3_TTS_NUM_PROCESSES", "1")
    assert mh.init_distributed() is False
    monkeypatch.setenv("QWEN3_TTS_COORDINATOR", "localhost:9999")
    assert mh.init_distributed(num_processes=1) is False
    monkeypatch.delenv("QWEN3_TTS_COORDINATOR")
    with pytest.raises(ValueError, match="no coordinator"):
        mh.init_distributed(num_processes=2, process_id=0)
    # one process: barrier and shutdown are no-ops
    mh.barrier("nothing")
    mh.shutdown_distributed()
    assert mh.world_devices()[0].device == "cuda:0"


def _hosts(n_hosts, per_host):
    return [pmesh.RankDevice(h * per_host + i, "cpu", f"host{h}")
            for h in range(n_hosts) for i in range(per_host)]


def test_serving_mesh_host_major_and_tp_within_a_host():
    """4 hosts x 4 ranks handed over interleaved: every tp row lies on
    one host, and the dp rows enumerate the hosts in order."""
    devs = _hosts(4, 4)
    scrambled = devs[::2] + devs[1::2]
    grid = mh.make_serving_mesh(tp=4, devices=scrambled).devices
    assert grid.shape == (4, 4)
    for row in range(4):
        assert len({d.host for d in grid[row]}) == 1, grid[row]
    assert [grid[r, 0].host for r in range(4)] == [f"host{h}"
                                                   for h in range(4)]
    assert [d.rank for d in grid.flat] == list(range(16))
    m = mh.make_serving_mesh(tp=2, devices=_cpus(8))
    assert m.shape == {"dp": 4, "tp": 2}
    with pytest.raises(ValueError, match="need 20 devices"):
        mh.make_serving_mesh(tp=4, dp=5, devices=_cpus(8))
    with pytest.raises(ValueError, match="leaves rank"):
        mh.make_serving_mesh(tp=2, dp=2, devices=_cpus(8))
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        mh.make_serving_mesh(tp=2, devices=["cuda:0"])


def test_uneven_host_rejected():
    devs = _hosts(1, 4) + [pmesh.RankDevice(4 + i, "cpu", "host1")
                           for i in range(2)]
    with pytest.raises(ValueError, match="must not cross hosts"):
        mh.make_serving_mesh(tp=4, devices=devs)
    with pytest.raises(ValueError, match="tp must be >= 1"):
        mh.make_serving_mesh(tp=0, devices=devs)


def test_host_slot_range():
    m = mh.make_serving_mesh(tp=2, devices=_hosts(2, 4))   # dp = 4
    assert m.shape == {"dp": 4, "tp": 2}
    # ranks 0 and 1 are dp group 0, ranks 6 and 7 group 3
    assert mh.host_slot_range(m, batch_size=8, process_index=0) == (0, 2)
    assert mh.host_slot_range(m, batch_size=8, process_index=1) == (0, 2)
    assert mh.host_slot_range(m, batch_size=8, process_index=7) == (6, 8)
    assert mh.host_slot_range(m, batch_size=8) == (0, 2)
    assert mh.host_slot_range(m, batch_size=8, process_index=99) == (0, 0)
    with pytest.raises(ValueError, match="not divisible"):
        mh.host_slot_range(m, batch_size=6, process_index=0)


def _mesh_at(dp, tp, dp_index, tp_index):
    """A layout-only mesh seen from the rank at (dp_index, tp_index)."""
    grid = np.empty((dp, tp), dtype=object)
    for r in range(dp * tp):
        grid[r // tp, r % tp] = pmesh.RankDevice(r, "cpu")
    return pmesh.Mesh(grid, rank=dp_index * tp + tp_index)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        elif k != "layers_list":
            yield prefix + k, v


@pytest.mark.parametrize("tp", [2, 4])
def test_local_shards_concatenate_back(tp):
    """Every leaf of the dense talker and code predictor at the
    _mesh_cfg geometry: the local shard's shape is the weight's with the
    spec's dim divided by tp, and the tp ranks' shards concatenate back
    to the weight; replicated leaves are the weight itself."""
    cfg = _mesh_cfg()
    params = tweights.init_random_params(cfg, seed=0, dtype=torch.float32)
    specs = {"talker": pmesh.talker_param_spec(),
             "code_predictor": pmesh.cp_param_spec()}
    shards = [pmesh.shard_params(_mesh_at(1, tp, 0, t), params)
              for t in range(tp)]
    for comp, spec in specs.items():
        flat_spec = dict(_leaves(spec))
        for name, w in _leaves(params[comp]):
            dim = flat_spec[name]
            parts = [dict(_leaves(s[comp]))[name] for s in shards]
            if dim is None:
                assert all(p is w for p in parts), name
                continue
            want = list(w.shape)
            want[dim] //= tp
            assert all(tuple(p.shape) == tuple(want) and p.is_contiguous()
                       for p in parts), name
            assert torch.equal(torch.cat(parts, dim=dim), w), name
    assert shards[0]["vocoder"] is params["vocoder"]


def test_qtensor_scales_under_row_and_column_splits():
    """An int8 code predictor at tp = 2: a column-parallel weight's
    scales split with its columns, a row-parallel weight keeps its whole
    scale vector; layers_list is rebuilt over the local stack."""
    cfg = _mesh_cfg()
    cp = tquant.quantize_code_predictor(tweights.init_random_params(
        cfg, seed=0, dtype=torch.float32)["code_predictor"])
    spec = pmesh.adapt_spec_to_params(pmesh.cp_param_spec(), cp)
    assert (spec["layers"]["q_proj"].q, spec["layers"]["q_proj"].scale) \
        == (2, 1)
    assert (spec["layers"]["o_proj"].q, spec["layers"]["o_proj"].scale) \
        == (1, None)
    assert (spec["lm_heads"].q, spec["lm_heads"].scale) == (2, 1)
    assert (spec["layers_list"][0]["q_proj"].q,
            spec["layers_list"][0]["down_proj"].scale) == (1, None)
    parts = [pmesh.shard_params(_mesh_at(1, 2, 0, t),
                                {"code_predictor": cp})["code_predictor"]
             for t in range(2)]
    q, o = cp["layers"]["q_proj"], cp["layers"]["o_proj"]
    assert torch.equal(torch.cat([p["layers"]["q_proj"].scale
                                  for p in parts], -1), q.scale)
    assert all(torch.equal(p["layers"]["o_proj"].scale, o.scale)
               for p in parts)
    assert torch.equal(torch.cat([p["layers"]["o_proj"].q for p in parts],
                                 1), o.q)
    assert parts[1]["layers_list"][0]["q_proj"].q.shape == (64, 64)


def test_fused_int8_talker_has_no_spec():
    cfg = _mesh_cfg()
    talker = tquant.quantize_talker(tweights.init_random_params(
        cfg, seed=0, dtype=torch.float32)["talker"])
    with pytest.raises(KeyError, match="fused int8 layouts are single-chip"):
        pmesh.adapt_spec_to_params(pmesh.talker_param_spec(), talker)


def test_local_state_shapes_where_they_are_built():
    """The decode state a rank builds at dp = 2 x tp = 2 (rank 3, at
    (1, 1)): geometry_of gives it Hq/tp, Hkv/tp and intermediate/tp; the
    batcher holds its dp group's slot block [2, 4) with the KV of its kv
    heads, dense or in the group's sub-pool, and its tp rank 1 serves no
    result."""
    from qwen3_tts_tpu_torch.serve.batching import ContinuousBatcher
    cfg = _mesh_cfg()
    m = _mesh_at(2, 2, 1, 1)
    geo = ttfm.geometry_of(cfg.talker, m)
    assert (geo.num_heads, geo.num_kv_heads, geo.intermediate_size) == (
        4, 2, 64)
    with pytest.raises(ValueError, match="does not split over tp=3"):
        ttfm.geometry_of(cfg.talker, _mesh_at(1, 3, 0, 0))
    params = tweights.init_random_params(cfg, seed=0, dtype=torch.float32)
    for paged in (False, True):
        b = ContinuousBatcher(cfg, params, batch_size=4, decode_chunk=4,
                              dtype=torch.float32, mesh=m, paged=paged,
                              page_size=16)
        assert (b._lo, b._hi, b._serves) == (2, 4, False)
        st = b._state
        assert st.pos.shape == (2,) and st.codes.shape[::2] == (2, 16)
        if paged:
            assert st.kv.pool.shape == (2, 2, b._pages_per_group, 16, 2, 16)
            assert st.kv.table.shape[0] == 2
            assert b.pool_pages == 2 * b._pages_per_group
        else:
            assert st.kv.shape == (2, 2, 2, 64, 2, 16)


def test_spawn_ranks_ends_the_others_and_keeps_the_logs(tmp_path):
    """spawn_ranks gives each rank its world variables; the first rank
    that fails ends the others, and each rank's output comes back; past
    the timeout every rank is ended and TimeoutError names them."""
    # rank 1 fails once ranks 0 and 2 have written their line
    prog = ("import os, sys, time; r = os.environ['QWEN3_TTS_PROCESS_ID']; "
            "store = os.environ['QWEN3_TTS_COORDINATOR']; "
            "print('rank', r, 'of', os.environ['QWEN3_TTS_NUM_PROCESSES'], "
            "store.startswith('file://'), flush=True)\n"
            "logs = [os.path.join(os.path.dirname(store[7:]), f'log{i}.txt') "
            "for i in (0, 2)]\n"
            "while r == '1' and not all(os.path.getsize(p) for p in logs): "
            "time.sleep(0.01)\n"
            "sys.exit(3) if r == '1' else time.sleep(60)")
    exits = mh.spawn_ranks([sys.executable, "-c", prog], 3, str(tmp_path),
                           timeout=50)
    assert [e.rank for e in exits] == [0, 1, 2]
    assert exits[1].code == 3 and exits[0].code < 0 and exits[2].code < 0
    assert [e.log.strip() for e in exits] == [f"rank {r} of 3 True"
                                              for r in range(3)]
    assert "rank 1 (exit 3)" in mh.format_exits(exits)
    d = tmp_path / "t"
    d.mkdir()
    with pytest.raises(TimeoutError, match="still running after 0.5 s"):
        mh.spawn_ranks([sys.executable, "-c", "import time; "
                        "time.sleep(60)"], 2, str(d), timeout=0.5)


def test_cli_reports_a_failing_rank(monkeypatch, capsys):
    """`--tp N`: a failing rank's exit code is the command's (not that of
    a rank ended for it), and its output goes to stderr."""
    from qwen3_tts_tpu_torch import cli
    seen = {}

    def fake(argv, n, store_dir, **kw):
        seen.update(n=n, argv=argv, **kw)
        return [mh.RankExit(0, -9, ""), mh.RankExit(1, 7, "boom on rank 1")]
    monkeypatch.setattr(mh, "spawn_ranks", fake)
    assert cli._run_ranks(2, ["ab", "--tp", "2"]) == 7
    err = capsys.readouterr().err
    assert "rank 1 exited 7" in err and "boom on rank 1" in err
    assert seen["n"] == 2 and seen["keep_rank0_output"]
    assert seen["argv"][-2:] == ["--tp", "2"] and seen["timeout"] == 3600


# ---------------------------------------------------------------------------
# tp = 2 and 4 over gloo, against JAX's sharded computations
# ---------------------------------------------------------------------------

def _mesh_cfg():
    """tests/test_engine_mesh.py's _mesh_cfg geometry (8 heads, 4 kv
    heads), the port's config."""
    talker = pconfig.TalkerConfig(
        num_layers=2, hidden_size=64, intermediate_size=128,
        num_heads=8, num_kv_heads=4, head_dim=16,
        text_vocab_size=151936, text_embed_dim=32, codec_vocab_size=3072,
        max_seq_len=64)
    cp_cfg = pconfig.CodePredictorConfig(
        num_layers=2, hidden_size=64, intermediate_size=128,
        num_heads=8, num_kv_heads=4, head_dim=16)
    return dataclasses.replace(pconfig.tiny_tts_config(max_tokens=6),
                               talker=talker, code_predictor=cp_cfg)


GEO = jtfm.TransformerGeometry(
    num_layers=2, hidden_size=64, intermediate_size=128,
    num_heads=8, num_kv_heads=4, head_dim=16,
    rms_norm_eps=1e-6, rope_theta=1e6)
CP_CFG = C.CodePredictorConfig(
    num_layers=2, hidden_size=64, intermediate_size=128,
    num_heads=8, num_kv_heads=4, head_dim=16)


def _jax_inputs():
    """tests/test_sharding.py's inputs of its two computations: a layer
    stack with x, pos and kv, and the int8 code predictor with hidden
    and c0e."""
    B, S = 4, 16
    return dict(
        stack=jtfm.init_stack_params(jax.random.PRNGKey(0), GEO),
        x=jax.random.normal(jax.random.PRNGKey(1), (B, 64)) * 0.3,
        pos=jnp.array([3, 5, 2, 7], jnp.int32),
        kv=jax.random.normal(jax.random.PRNGKey(2), (2, 2, B, S, 4, 16)) * 0.1,
        cp=jquant.quantize_code_predictor(jcp.init_cp_params(
            jax.random.PRNGKey(0), CP_CFG, dtype=jnp.float32)),
        hidden=jax.random.normal(jax.random.PRNGKey(1), (B, 64)) * 0.3,
        c0e=jax.random.normal(jax.random.PRNGKey(2), (B, 64)) * 0.3)


def _jax_sharded(tp, inp):
    """tests/test_sharding.py's two computations on a (2, tp) virtual
    mesh, greedy: the layer stack's decode step and the int8 code
    predictor's codes, as numpy."""
    mesh = jmesh.make_mesh(2, tp)
    put = lambda a, s: jax.device_put(a, NamedSharding(mesh, s))  # noqa
    p_sh = jax.tree.map(put, inp["stack"], jmesh.layer_stack_spec(),
                        is_leaf=lambda n: isinstance(n, P))
    with mesh:
        h, new_kv = jax.jit(
            lambda p, xx, pp, kk: jtfm.decode_step(p, xx, pp, kk, GEO))(
                p_sh, put(inp["x"], P("dp", None)),
                put(inp["pos"], P("dp")),
                put(inp["kv"], jmesh.kv_cache_spec()))
    scfg = C.SamplingConfig(cp_temperature=0.0)
    spec = jmesh.adapt_spec_to_params(jmesh.cp_param_spec(), inp["cp"])
    cp_sh = jax.tree.map(put, inp["cp"], spec,
                         is_leaf=lambda n: isinstance(n, P))
    with mesh:
        codes = jax.jit(
            lambda p, hh, cc: jcp.predict_codes(p, hh, cc,
                                                jax.random.PRNGKey(3),
                                                CP_CFG, scfg))(
                cp_sh, put(inp["hidden"], P("dp", None)),
                put(inp["c0e"], P("dp", None)))
    return dict(want_h=np.array(h), want_kv=np.array(new_kv),
                want_codes=np.array(codes))


def _npy(tree):
    if isinstance(tree, dict):
        return {k: _npy(v) for k, v in tree.items() if k != "layers_list"}
    if isinstance(tree, jquant.QTensor):
        return (np.array(tree.q), np.array(tree.scale))
    return np.array(tree)


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_decode_and_int8_cp_match_jax_and_no_mesh(tp, tmp_path):
    """One spawn of tp gloo ranks: a layer stack's decode step within
    f32 atol 1e-5 of JAX's sharded step and of the port's unsharded step
    (hidden, and the KV concatenated over the ranks' kv heads), the hidden
    equal bit for bit on every rank; the int8 code predictor's greedy
    codes (its per-step path, K1 over the shards) equal on every rank to
    JAX's sharded codes and to the port's unsharded per-step codes."""
    inp = _jax_inputs()
    j = {k: _npy(v) for k, v in inp.items()}
    cfg = dataclasses.replace(
        _mesh_cfg(), sampling=pconfig.SamplingConfig(cp_temperature=0.0))
    stack = tweights.from_jax_numpy({"layers": j["stack"]})
    cp = tweights.from_jax_numpy({"c": j["cp"]})["c"]
    tweights.save_pytree_npz(str(tmp_path / "params.npz"), stack,
                             config=cfg)
    tweights.save_pytree_npz(str(tmp_path / "cp.npz"), cp)
    np.savez(tmp_path / "in.npz", **{k: j[k] for k in
                                     ("x", "pos", "kv", "hidden", "c0e")})
    ranks = W.start_ranks("layers", 1, tp, str(tmp_path))
    j.update(_jax_sharded(tp, inp))

    geo = ttfm.geometry_of(cfg.talker)
    want_h, want_kv = ttfm.decode_step(
        stack["layers"], torch.from_numpy(j["x"]),
        torch.from_numpy(j["pos"]).long(), torch.from_numpy(j["kv"]), geo)
    # the port's unsharded per-step path, the one a tp rank runs: one
    # device takes it past K2's 8 rows (K2's bf16 activations give other
    # greedy codes), so the 4 rows are tiled to 9; a row's codes depend
    # only on its own inputs
    B = j["hidden"].shape[0]
    tile = lambda a: torch.from_numpy(np.tile(a, (3, 1))[:9])  # noqa: E731
    seeds = tsmp.token_seeds(tsmp.batch_keys(0, 9), torch.zeros(9))[:, 1:]
    want_codes = tcp.predict_codes(cp, tile(j["hidden"]), tile(j["c0e"]),
                                   seeds, cfg.code_predictor,
                                   cfg.sampling)[:B].numpy()
    outs = ranks.result()
    kv = np.concatenate([o["kv"] for o in outs], axis=4)
    for r, o in enumerate(outs):
        assert tuple(o["coords"]) == (0, r)
        np.testing.assert_allclose(o["hidden"], j["want_h"], atol=ATOL,
                                   rtol=0)
        np.testing.assert_allclose(o["hidden"], want_h.numpy(), atol=ATOL,
                                   rtol=0)
        np.testing.assert_array_equal(o["hidden"], outs[0]["hidden"])
        np.testing.assert_array_equal(o["codes"], j["want_codes"])
        np.testing.assert_array_equal(o["codes"], want_codes)
    np.testing.assert_allclose(kv, j["want_kv"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(kv, want_kv.numpy(), atol=ATOL, rtol=0)
