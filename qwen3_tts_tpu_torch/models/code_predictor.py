"""Code predictor: the 5-layer Qwen3-style transformer that expands each
talker token (hidden, code_0) into codec groups 1..15. Twin of
qwen3_tts_tpu/models/code_predictor.py.

Per talker token: a 2-token prefill (the talker hidden, then the
talker's codec_embedding[code_0]), group 1 from lm_head_0, then 14 AR
steps, step i embedding the previous code with codec_embs[i-1] and
reading lm_heads[i]. Every input embedding goes through the
small_to_mtp projection first."""

from __future__ import annotations

import torch

from qwen3_tts_tpu_torch.config import CodePredictorConfig, SamplingConfig
from qwen3_tts_tpu_torch.models import transformer as tfm
from qwen3_tts_tpu_torch.models.module import WeightTree
from qwen3_tts_tpu_torch.ops import quant
from qwen3_tts_tpu_torch.ops import sampling as smp
from qwen3_tts_tpu_torch.ops.kernels.cp_decode import (MAX_B,
                                                       cp_decode_steps,
                                                       sample_tokens)
from qwen3_tts_tpu_torch.parallel.mesh import tp_active, tp_all_gather


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
    every tp rank draws the same codes."""
    geo = tfm.geometry_of(cfg, mesh)
    B = hidden.shape[0]
    S = cfg.max_seq_len
    dev = hidden.device
    kv = tfm.init_kv_cache(geo, B, S, dtype=hidden.dtype, device=dev)

    # 2-token prefill (positions 0, 1); causally masked, so exact
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
    greedy = scfg.cp_temperature <= 0.0

    if _fused_kernel_ok(params, B, mesh):
        cos, sin = tfm.rope_cos_sin(torch.arange(S, device=dev),
                                    cfg.head_dim, cfg.rope_theta)
        toks14 = cp_decode_steps(
            params, tok0, kv, cos, sin, steps_seed, eps=cfg.rms_norm_eps,
            top_k=scfg.cp_top_k, temperature=float(scfg.cp_temperature),
            greedy=greedy)                                  # (14, B)
        return torch.cat([tok0[:, None], toks14.T], dim=1)

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
