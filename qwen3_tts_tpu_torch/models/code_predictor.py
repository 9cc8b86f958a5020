"""Code predictor: the 5-layer Qwen3-style transformer that expands each
talker token (hidden, code_0) into codec groups 1..15. Twin of
qwen3_tts_tpu/models/code_predictor.py.

Per talker token: a 2-token prefill (the talker hidden, then the
talker's codec_embedding[code_0]), group 1 from lm_head_0, then 14 AR
steps, step i embedding the previous code with codec_embs[i-1] and
reading lm_heads[i]. Every input embedding goes through the
small_to_mtp projection first."""

from __future__ import annotations

import collections
import threading

import torch

from qwen3_tts_tpu_torch.config import CodePredictorConfig, SamplingConfig
from qwen3_tts_tpu_torch.models import transformer as tfm
from qwen3_tts_tpu_torch.models.module import WeightTree
from qwen3_tts_tpu_torch.ops import quant
from qwen3_tts_tpu_torch.ops import sampling as smp
from qwen3_tts_tpu_torch.ops.kernels import qmatmul as k_qmm
from qwen3_tts_tpu_torch.ops.kernels.cp_decode import (MAX_B,
                                                       cp_decode_steps,
                                                       sample_tokens)
from qwen3_tts_tpu_torch.parallel.mesh import tp_active, tp_all_gather
from qwen3_tts_tpu_torch.utils import profiling


class CodePredictor(WeightTree):
    """The code predictor's weights (JAX names and layouts)."""

    def __init__(self, cfg: CodePredictorConfig, params: dict):
        super().__init__(params)
        self.cfg = cfg


def _project_in(params: dict, x: torch.Tensor, mesh=None) -> torch.Tensor:
    """small_to_mtp_projection applied to every layer input embedding; on
    a tp ``mesh`` a column shard, gathered to the whole hidden width (the
    layers take the whole hidden)."""
    out = x.float() @ params["mtp_proj_w"].float() + \
        params["mtp_proj_b"].float()
    return tp_all_gather(out, mesh).to(x.dtype)


def _fused_kernel_ok(params: dict, B: int, mesh=None) -> bool:
    """K2 (ops/kernels/cp_decode.py) takes steps 1..14 for int8 params
    (QTensor layer stack and lm_heads) and B <= 8, off a tp mesh (K2
    holds whole heads; a dp rank holds the whole code predictor and keeps
    it); past 8 rows, or under tp, the per-step path below runs, with its
    int8 products on K1."""
    return (B <= MAX_B and not tp_active(mesh)
            and isinstance(params.get("lm_heads"), quant.QTensor)
            and isinstance(params["layers"].get("q_proj"), quant.QTensor))


def _prelude(params: dict, hidden: torch.Tensor, code0_embed: torch.Tensor,
             seeds: torch.Tensor, cfg: CodePredictorConfig,
             scfg: SamplingConfig, mesh=None, rope: bool = False):
    """Everything before the AR steps: a fresh KV cache, the 2-token
    prefill (positions 0, 1; causally masked, so exact), the final norm,
    lm_head 0 and the group-1 draw. Returns (tok0 (B,) int32, kv,
    steps_seed (B,) int32, (cos, sin) over the cache's positions for K2
    when ``rope``, else None). No host read: the same chain runs eagerly
    or as a CUDA graph (``_PreludeGraph``)."""
    geo = tfm.geometry_of(cfg, mesh)
    B = hidden.shape[0]
    S = cfg.max_seq_len
    dev = hidden.device
    kv = tfm.init_kv_cache(geo, B, S, dtype=hidden.dtype, device=dev)

    x2 = _project_in(params, torch.stack([hidden, code0_embed], dim=1), mesh)
    positions = torch.arange(2, device=dev).expand(B, 2)
    mask = tfm.causal_mask(B, 2, torch.full((B,), 2, device=dev))
    layers = params.get("layers_list") or tfm._layers(params["layers"])
    h, kv = tfm.forward_prefill_unrolled(layers, x2, positions, mask, geo,
                                         kv, mesh)
    h_last = tfm.rms_norm(h, params["final_norm"], cfg.rms_norm_eps)[:, -1]

    logits0 = tp_all_gather(quant.matmul(h_last, params["lm_heads"][0]),
                            mesh)
    tok0 = smp.topk_temperature_sample(
        logits0, seeds[:, 0], scfg.cp_top_k,
        scfg.cp_temperature).to(torch.int32)
    steps_seed = smp.as_int32(seeds[:, 1])
    cos_sin = (tfm.rope_cos_sin(torch.arange(S, device=dev), cfg.head_dim,
                                cfg.rope_theta) if rope else None)
    return tok0, kv, steps_seed, cos_sin


# the kernels the prelude launches (K1's routes), whose ``.launches``
# count what a replay runs as the eager prelude's calls would
_KERNELS = (k_qmm.qmatmul, k_qmm.qmatmul_qsplit, k_qmm.qmatmul_tile)


class _PreludeGraph:
    """``_prelude`` captured as one CUDA graph for one key (see
    ``_prelude_graph``). Its inputs are static buffers that ``replay``
    fills; its outputs are the graph's own tensors, overwritten by the
    next replay, so a caller reads them under ``lock`` and enqueues every
    read on the capture key's stream before it lets go: a later replay
    on that stream then runs after those reads. The capture's kernel
    calls launch nothing, so their ``.launches`` are taken back and
    added again at each replay."""

    def __init__(self, params: dict, hidden: torch.Tensor,
                 code0_embed: torch.Tensor, seeds: torch.Tensor,
                 cfg: CodePredictorConfig, scfg: SamplingConfig, rope: bool):
        self.params = params      # the weights the graph reads stay alive
        self.device = hidden.device
        self.lock = threading.Lock()
        self.inputs = (hidden.clone(), code0_embed.clone(), seeds.clone())
        run = lambda: _prelude(params, *self.inputs, cfg, scfg,  # noqa: E731
                               rope=rope)
        # warm up on a side stream (builds and loads K1, cuBLAS workspaces)
        side = torch.cuda.Stream(device=hidden.device)
        side.wait_stream(torch.cuda.current_stream(hidden.device))
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream(hidden.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        n0 = [k.launches for k in _KERNELS]
        # thread_local: another thread's calls do not break the capture
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.outputs = run()
        self.launches = [k.launches - n for k, n in zip(_KERNELS, n0)]
        for k, n in zip(_KERNELS, self.launches):
            k.launches -= n
        profiling.count("cp_graph_captures")

    def replay(self, hidden: torch.Tensor, code0_embed: torch.Tensor,
               seeds: torch.Tensor):
        for buf, x in zip(self.inputs, (hidden, code0_embed, seeds)):
            buf.copy_(x)
        self.graph.replay()
        for k, n in zip(_KERNELS, self.launches):
            k.launches += n
        profiling.count("cp_graph_replays")
        return self.outputs


# captured preludes, least recently used first; a batcher or an engine
# uses one B, synthesize_long another, so a few keys cover a process. A
# graph holds its weights and its memory pool until newer keys push it
# out, also past the engine or batcher that made it
_GRAPHS: "collections.OrderedDict[tuple, _PreludeGraph]" = \
    collections.OrderedDict()
MAX_GRAPHS = 4
_GRAPHS_LOCK = threading.Lock()


def _graphed(device: torch.device, mesh=None) -> bool:
    """Whether the prelude replays a CUDA graph: on a card, off a tp mesh
    (there _project_in and lm_head 0 gather over the tp group, and a
    collective is not captured)."""
    return device.type == "cuda" and not tp_active(mesh)


def _prelude_graph(params: dict, hidden: torch.Tensor,
                   code0_embed: torch.Tensor, seeds: torch.Tensor,
                   cfg: CodePredictorConfig, scfg: SamplingConfig,
                   rope: bool) -> _PreludeGraph:
    """The graph for this call, captured at a key's first call. The key
    holds what a capture bakes in: the inputs' shapes, dtypes and device,
    the weights (by identity; the graph keeps them), the configuration,
    the sampling constants, the stream it is replayed on and the
    inference mode of the tensors it makes. A failed capture raises."""
    dev = hidden.device
    key = (tuple((tuple(t.shape), t.dtype) for t in
                 (hidden, code0_embed, seeds)), dev, id(params), cfg,
           scfg.cp_top_k, float(scfg.cp_temperature), rope,
           torch.cuda.current_stream(dev).cuda_stream,
           torch.is_inference_mode_enabled())
    with _GRAPHS_LOCK:
        g = _GRAPHS.get(key)
        if g is not None:
            _GRAPHS.move_to_end(key)
            return g
        g = _PreludeGraph(params, hidden, code0_embed, seeds, cfg, scfg,
                          rope)
        _GRAPHS[key] = g
        if len(_GRAPHS) > MAX_GRAPHS:
            old = _GRAPHS.popitem(last=False)[1]
            with old.lock:      # no caller still reads its outputs
                torch.cuda.synchronize(old.device)
        return g


def predict_codes(params: dict, hidden: torch.Tensor,
                  code0_embed: torch.Tensor, seeds: torch.Tensor,
                  cfg: CodePredictorConfig, scfg: SamplingConfig,
                  mesh=None) -> torch.Tensor:
    """Groups 1..15 for each row: hidden (B, H) is the talker hidden after
    its final norm, code0_embed (B, H) the talker's codec_embedding of
    code_0. Returns (B, 15) int32. seeds (B, 2): each row's seeds of its
    token's CP draws (columns SITE_CP_GROUP1 and SITE_CP_STEPS of
    ops/sampling.token_seeds). Group 1 draws with the first; groups
    2..15 with the second, which K2, or past K2's batch limit the same
    sampler per step, hashes with the step index. So a row's codes do
    not depend on the rest of the batch, and the two paths draw the same
    noise. ``mesh``: the tp mesh of a sharded code predictor, whose
    lm_head logits are gathered over the tp group before sampling, so
    every tp rank draws the same codes.

    On a card and off a tp mesh the prelude (``_prelude``) replays as one
    CUDA graph, captured at its key's first call; elsewhere it runs
    eagerly. Counted in utils/profiling as ``cp_graph_replays``,
    ``cp_graph_captures`` and ``cp_eager_calls``."""
    fused = _fused_kernel_ok(params, hidden.shape[0], mesh)
    if not _graphed(hidden.device, mesh):
        profiling.count("cp_eager_calls")
        return _decode(params, *_prelude(params, hidden, code0_embed, seeds,
                                         cfg, scfg, mesh, rope=fused),
                       cfg, scfg, mesh)
    g = _prelude_graph(params, hidden, code0_embed, seeds, cfg, scfg, fused)
    with g.lock:
        return _decode(params, *g.replay(hidden, code0_embed, seeds), cfg,
                       scfg, mesh)



def _decode(params: dict, tok0: torch.Tensor, kv: torch.Tensor,
            steps_seed: torch.Tensor, cos_sin, cfg: CodePredictorConfig,
            scfg: SamplingConfig, mesh=None) -> torch.Tensor:
    """Groups 2..15 after the prelude: K2 when ``cos_sin`` is given (its
    rope tables), else the per-step path. Returns (B, 15) int32, a new
    tensor (nothing of the prelude's outputs is kept)."""
    B = tok0.shape[0]
    greedy = scfg.cp_temperature <= 0.0
    if cos_sin is not None:
        toks14 = cp_decode_steps(
            params, tok0, kv, *cos_sin, steps_seed, eps=cfg.rms_norm_eps,
            top_k=scfg.cp_top_k, temperature=float(scfg.cp_temperature),
            greedy=greedy)                                  # (14, B)
        return torch.cat([tok0[:, None], toks14.T], dim=1)

    geo = tfm.geometry_of(cfg, mesh)
    dev = tok0.device
    toks = [tok0]
    tok = tok0
    for step in range(1, cfg.num_groups):
        emb = _project_in(params, params["codec_embs"][step - 1][tok.long()],
                          mesh)
        pos = torch.full((B,), step + 1, device=dev, dtype=torch.long)
        hh, kv = tfm.decode_step(params["layers"], emb, pos, kv, geo, mesh)
        hh = tfm.rms_norm(hh, params["final_norm"], cfg.rms_norm_eps)
        logits = tp_all_gather(quant.matmul(hh, params["lm_heads"][step]),
                               mesh)
        tok = sample_tokens(logits, steps_seed[:, None], step - 1,
                            top_k=scfg.cp_top_k,
                            temperature=float(scfg.cp_temperature),
                            greedy=greedy)[:, 0]
        toks.append(tok)
    return torch.stack(toks, dim=1)
