"""Talker LLM: the 28-layer Qwen3 transformer run on embeddings, plus its
TTS embedding surface (text embedding + projection MLP, codec embedding,
codec head). Twin of qwen3_tts_tpu/models/talker.py."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from qwen3_tts_tpu_torch.config import (
    ASSISTANT_TOKEN_ID,
    CODEC_BOS_ID,
    CODEC_NOTHINK_ID,
    CODEC_PAD_ID,
    CODEC_THINK_BOS_ID,
    CODEC_THINK_EOS_ID,
    IM_START_TOKEN_ID,
    NEWLINE_TOKEN_ID,
    TTS_BOS_TOKEN_ID,
    TTS_EOS_TOKEN_ID,
    TTS_PAD_TOKEN_ID,
    TalkerConfig,
)
from qwen3_tts_tpu_torch.models import transformer as tfm
from qwen3_tts_tpu_torch.models.module import WeightTree
from qwen3_tts_tpu_torch.ops import quant
from qwen3_tts_tpu_torch.ops.kernels.talker_step import (
    MAX_B, talker_decode_step_fused)
from qwen3_tts_tpu_torch.parallel.mesh import (tp_active, tp_all_gather,
                                               tp_all_reduce)

# prefix positions besides the N text tokens:
# 3 role + 3 think + 1 transition + 1 tts_eos + 1 final codec_bos
PREFIX_EXTRA = 9


class Talker(WeightTree):
    """The talker's weights (JAX names and layouts)."""

    def __init__(self, cfg: TalkerConfig, params: dict):
        super().__init__(params)
        self.cfg = cfg


def embed_text(params: dict, token_ids: torch.Tensor,
               mesh=None) -> torch.Tensor:
    """text_embedding lookup + Linear -> SiLU -> Linear projection;
    (...,) ids -> (..., hidden) in the embedding's dtype. On a tp
    ``mesh`` the table is this rank's vocabulary rows: a masked local
    lookup, zero off them, summed over the tp group (exact: one term is
    not zero); fc1 is a column shard and fc2 a row shard whose f32
    partial sums add up over the group before its bias."""
    table = params["text_embedding"]
    if tp_active(mesh):
        lo = mesh.tp_index * table.shape[0]
        local = token_ids.long() - lo
        mine = (local >= 0) & (local < table.shape[0])
        e = table[torch.where(mine, local, 0)].float()
        e = tp_all_reduce(e * mine[..., None], mesh).to(table.dtype)
    else:
        e = table[token_ids]
    h = e.float() @ params["proj_fc1_w"].float() + params["proj_fc1_b"].float()
    h = tfm.silu(h)
    out = tp_all_reduce(h.to(e.dtype).float() @ params["proj_fc2_w"].float(),
                        mesh)
    return (out + params["proj_fc2_b"].float()).to(e.dtype)


def codec_logits(params: dict, hidden: torch.Tensor,
                 mesh=None) -> torch.Tensor:
    """hidden (..., H) -> (..., codec_vocab) f32; codec_head may be int8.
    On a tp ``mesh`` codec_head is a vocabulary shard, and the logits are
    gathered over the tp group."""
    return tp_all_gather(quant.matmul(hidden, params["codec_head"]), mesh)


def build_prefix(params: dict, text_token_ids: torch.Tensor, n_text,
                 mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dual-stream prefix of fixed shape (N_pad + PREFIX_EXTRA, H):

      [0:3]   role: proj(text_emb([im_start, assistant, newline]))
      [3:6]   tts_pad + codec_emb([nothink, think_bos, think_eos])
      [6]     tts_bos + codec_emb[pad]
      [7:7+N] proj(text_token_i) + codec_emb[pad]
      [7+N]   tts_eos + codec_emb[pad]
      [8+N]   tts_pad + codec_emb[bos]

    Rows past 8+N are zero. ``n_text`` is clamped to N_pad, so an
    oversized count cannot push the tail rows out of the prefix. ``mesh``:
    the tp mesh of a sharded talker (embed_text). Returns (prefix,
    prefix_len = n_text + PREFIX_EXTRA as int32)."""
    dev = text_token_ids.device
    n_pad = text_token_ids.shape[0]
    n_text = torch.clamp(torch.as_tensor(n_text, dtype=torch.int32,
                                         device=dev), max=n_pad)
    ce = params["codec_embedding"]

    def ids(*xs):
        return torch.tensor(xs, dtype=torch.long, device=dev)

    tts_pad_e, tts_bos_e, tts_eos_e = embed_text(
        params, ids(TTS_PAD_TOKEN_ID, TTS_BOS_TOKEN_ID, TTS_EOS_TOKEN_ID),
        mesh)
    role = embed_text(params, ids(IM_START_TOKEN_ID, ASSISTANT_TOKEN_ID,
                                  NEWLINE_TOKEN_ID), mesh)
    think = tts_pad_e[None, :] + ce[ids(CODEC_NOTHINK_ID, CODEC_THINK_BOS_ID,
                                        CODEC_THINK_EOS_ID)]
    transition = (tts_bos_e + ce[CODEC_PAD_ID])[None, :]
    text_e = (embed_text(params, text_token_ids.long(), mesh)
              + ce[CODEC_PAD_ID][None])

    eos_row = tts_eos_e + ce[CODEC_PAD_ID]
    final_row = tts_pad_e + ce[CODEC_BOS_ID]
    ridx = torch.arange(n_pad + 2, device=dev)[:, None]
    text_pad2 = torch.cat([text_e, torch.zeros_like(text_e[:2])], dim=0)
    zeros = torch.zeros_like(text_pad2)
    tail = torch.where(ridx < n_text, text_pad2,
                       torch.where(ridx == n_text, eos_row[None],
                                   torch.where(ridx == n_text + 1,
                                               final_row[None], zeros)))
    prefix = torch.cat([role, think, transition, tail], dim=0)
    return prefix.to(text_e.dtype), n_text + PREFIX_EXTRA


def clone_frame_embeds(params: dict, cp_codec_embs: torch.Tensor,
                       ref_codes: torch.Tensor, mesh=None) -> torch.Tensor:
    """Prefix-continuation embeddings of reference codec frames (voice
    cloning): the decode loop's feedback formula applied to (R, 16)
    codes, codec_embedding[c_0] + sum_g cp_codec_embs[g-1][c_g] +
    tts_pad_embed per frame."""
    ce = params["codec_embedding"]
    dev = ref_codes.device
    tts_pad_e = embed_text(
        params, torch.tensor([TTS_PAD_TOKEN_ID], device=dev), mesh)[0]
    codes = ref_codes.long()
    c0 = ce[codes[:, 0]]                                       # (R, H)
    g_idx = torch.arange(cp_codec_embs.shape[0], device=dev)[None, :]
    rest = cp_codec_embs[g_idx, codes[:, 1:]].sum(dim=1)
    return c0 + rest.to(c0.dtype) + tts_pad_e[None, :]


def build_prefix_cloned(params: dict, cp_codec_embs: torch.Tensor,
                        text_token_ids: torch.Tensor, n_text,
                        ref_codes: torch.Tensor, n_ref: int,
                        mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """In-context voice-cloning prefix: the dual-stream prefix over the
    reference transcript followed by the target text (``text_token_ids``,
    N_pad), then the reference audio's codec frames (``ref_codes``, R_pad
    rows of which the first ``n_ref`` are real) as continuation rows, so
    the decode continues the reference speaker into the target text.
    Returns (prefix (N_pad + PREFIX_EXTRA + R_pad, H), prefix_len =
    n_text + PREFIX_EXTRA + n_ref)."""
    prefix, plen = build_prefix(params, text_token_ids, n_text, mesh)
    frames = clone_frame_embeds(params, cp_codec_embs, ref_codes,
                                mesh).to(prefix.dtype)
    R = frames.shape[0]
    rows = torch.arange(R, device=frames.device)
    out = torch.cat([prefix, torch.zeros_like(frames)], dim=0)
    vals = torch.where((rows < n_ref)[:, None], frames,
                       torch.zeros_like(frames))
    # the base prefix is zero from plen on, so adding places the frames
    # at [plen, plen + n_ref), as the JAX package's scatter-add does
    out.index_add_(0, plen.long() + rows, vals)
    return out, plen + int(n_ref)


def request_prefix(params: dict, cp_codec_embs: torch.Tensor,
                   ids: np.ndarray, n_text: int, ref=None,
                   mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """A request's prefix from its host ids, on the talker's device and in
    its dtype: the dual-stream prefix, or with ``ref`` = (padded reference
    frames (b, 16), n_ref) from bucket_ref_frames the cloned one. The
    engine and the batcher both build their prefixes here, so one prompt
    gives both the same prefix. Returns (prefix (P, H), prefix_len)."""
    ce = params["codec_embedding"]
    ids_t = torch.from_numpy(ids).to(ce.device)
    if ref is None:
        prefix, plen = build_prefix(params, ids_t, n_text, mesh)
    else:
        padded, n_ref = ref
        prefix, plen = build_prefix_cloned(
            params, cp_codec_embs, ids_t, n_text,
            torch.from_numpy(padded).to(ce.device), n_ref, mesh)
    return prefix.to(ce.dtype), plen


def cloned_ref_limit(cap: int, text_pad: int) -> int:
    """KV rows a cloning request's reference frames may take: the
    allocation ``cap`` less the padded text rows, the PREFIX_EXTRA
    special rows and 8 rows of decode headroom. The one home of this
    clamp: the engine and the batcher must build the same cloned prefix
    for the same prompt."""
    return max(int(cap) - PREFIX_EXTRA - int(text_pad) - 8, 0)


def bucket_ref_frames(limit: int, ref_codes_np) -> Tuple[np.ndarray, int]:
    """The reference codec frames clamped to ``limit`` rows and zero-padded
    to a bucket (16/32/64/128/256, none past the limit; past those a
    multiple of 64 of the kept length, clamped to the limit). Shared by
    the engine and the batcher, so both pad alike. Returns (padded (b, 16)
    np.int32, n_ref kept)."""
    n_ref = min(len(ref_codes_np), max(int(limit), 0))
    b = next((bk for bk in (16, 32, 64, 128, 256)
              if n_ref <= bk and bk <= limit), None)
    if b is None:
        b = max(min(-(-n_ref // 64) * 64, max(int(limit), 1)), 1)
    padded = np.zeros((b, 16), np.int32)
    padded[:n_ref] = np.asarray(ref_codes_np, np.int32)[:n_ref, :16]
    return padded, n_ref


def prefill(params: dict, prefix: torch.Tensor, prefix_len: torch.Tensor,
            kv_cache: torch.Tensor, cfg: TalkerConfig, mesh=None):
    """Prefill a (B, P_pad, H) prefix. Returns (hidden at the last real
    position after the final norm (B, H), kv_cache filled in place).
    ``mesh``: the tp mesh of a sharded talker (the cache holds this
    rank's kv heads)."""
    geo = tfm.geometry_of(cfg, mesh)
    B, P, _ = prefix.shape
    positions = torch.arange(P, device=prefix.device).expand(B, P)
    mask = tfm.causal_mask(B, P, prefix_len)
    h, kv = tfm.forward_prefill(params["layers"], prefix, positions, mask,
                                geo, kv_cache, mesh)
    h = tfm.rms_norm(h, params["final_norm"], cfg.rms_norm_eps)
    last = h[torch.arange(B, device=h.device), prefix_len.long() - 1]
    return last, kv


def prefill_chunked(params: dict, prefix: torch.Tensor,
                    prefix_len: torch.Tensor, kv_cache: torch.Tensor,
                    cfg: TalkerConfig, chunk: int = 128):
    """Block-wise prefill in windows of ``chunk`` tokens (the reference's
    128-token chunked prefill): the prefix zero-padded to whole windows,
    each window through tfm.forward_window, so attention holds chunk x
    (offset + chunk) scores, not P x P. Causal masking makes it the
    one-shot ``prefill`` up to the order of sums. Raises ValueError when
    the windows would write past the dense cache's S. Returns (hidden at
    the last real position after the final norm (B, H), kv_cache filled
    in place)."""
    geo = tfm.geometry_of(cfg)
    B, P, _ = prefix.shape
    n_chunks = -(-P // chunk)
    S = kv_cache.shape[3]
    if n_chunks * chunk > S:
        raise ValueError(
            f"chunked prefill needs n_chunks*chunk <= kv capacity: "
            f"{n_chunks}*{chunk} > {S} (prefix_pad={P})")
    prefix = torch.nn.functional.pad(prefix, (0, 0, 0, n_chunks * chunk - P))
    hs = []
    for i in range(n_chunks):
        h, kv_cache = tfm.forward_window(
            params["layers"], prefix[:, i * chunk:(i + 1) * chunk],
            i * chunk, kv_cache, geo)
        hs.append(h)
    h = tfm.rms_norm(torch.cat(hs, dim=1), params["final_norm"],
                     cfg.rms_norm_eps)
    last = h[torch.arange(B, device=h.device), prefix_len.long() - 1]
    return last, kv_cache


def _fused_step_ok(params: dict, B: int, mesh=None) -> bool:
    """The fused decode step (K3) applies to the fused-int8 layer layout
    of ops/quant.quantize_talker at 1 <= B <= talker_step.MAX_B, off a tp
    mesh (it holds whole heads); on the card the kernel runs, on the CPU
    its plain version. Past MAX_B rows the per-layer path runs over the
    same int8 stack, its products on K1 (the JAX package's
    decode_step_unrolled)."""
    layers = params.get("layers", {})
    return (B <= MAX_B and not tp_active(mesh)
            and isinstance(layers.get("qkv_proj"), quant.QTensor)
            and isinstance(layers.get("gateup_proj"), quant.QTensor))


def decode_step(params: dict, feedback: torch.Tensor, pos: torch.Tensor,
                kv_cache, cfg: TalkerConfig,
                rope_table: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                mesh=None):
    """One talker decode step on a feedback embedding (B, H). Returns the
    final-norm hidden (B, H) and the cache (updated in place): a
    ``tfm.PagedKV`` goes to the paged step (attention on K4), a dense
    cache to K3 where it applies, else to the per-layer step (attention
    on K5 under ``attention_impl="pallas"``). ``rope_table``: precomputed
    (S, Dh) cos/sin tables for K3, which loop callers pass so they are
    not rebuilt every step. ``mesh``: the tp mesh of a sharded talker."""
    geo = tfm.geometry_of(cfg, mesh)
    if isinstance(kv_cache, tfm.PagedKV):
        h, kv = tfm.paged_decode_step(params["layers"], feedback, pos,
                                      kv_cache, geo, mesh)
    elif _fused_step_ok(params, feedback.shape[0], mesh):
        if rope_table is None:
            rope_table = tfm.rope_cos_sin(
                torch.arange(kv_cache.shape[3], device=kv_cache.device),
                cfg.head_dim, cfg.rope_theta)
        h, kv = talker_decode_step_fused(
            params["layers"], feedback, pos, kv_cache, rope_table[0],
            rope_table[1], eps=cfg.rms_norm_eps)
    else:
        h, kv = tfm.decode_step(params["layers"], feedback, pos, kv_cache,
                                geo, mesh)
    return tfm.rms_norm(h, params["final_norm"], cfg.rms_norm_eps), kv
