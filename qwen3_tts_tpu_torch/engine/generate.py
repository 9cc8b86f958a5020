"""The decode loop: sample code_0 -> code predictor (groups 1..15) ->
feedback embedding -> talker decode step. Twin of
qwen3_tts_tpu/engine/generate.py.

Feedback: codec_embedding[code_0] + sum_g cp codec_embs[g-1][code_g]
+ tts_pad_embed. Rows decode in lockstep; a finished row freezes. All
shapes are fixed, so a step enqueues its work without a host round trip:
the loop reads ``done`` back only every ``DONE_CHECK_STRIDE`` steps.
Every row carries its own key, and its draws hash (key, its token
counter, draw site) (ops/sampling.py), so a row decodes the same codes
whatever else shares the batch. The talker KV is a dense cache or a
``tfm.PagedKV`` (the paged batcher).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from qwen3_tts_tpu_torch.config import (
    CODEC_EOS_ID,
    NUM_AUDIO_CODES,
    TTS_PAD_TOKEN_ID,
    TTSConfig,
)
from qwen3_tts_tpu_torch.models import code_predictor as cp
from qwen3_tts_tpu_torch.models import talker as tk
from qwen3_tts_tpu_torch.models import transformer as tfm
from qwen3_tts_tpu_torch.ops import sampling as smp
from qwen3_tts_tpu_torch.utils import profiling

# steps between host reads of ``done`` (each read waits for the device)
DONE_CHECK_STRIDE = 8


@dataclasses.dataclass
class GenState:
    """State of the decode loop; every field a fixed-shape tensor."""

    kv: object              # talker KV: dense (L, 2, B, S, Hkv, Dh) or
    #                         tfm.PagedKV
    pos: torch.Tensor       # (B,) next talker write position
    hidden: torch.Tensor    # (B, H) last talker hidden (post final norm)
    ring: torch.Tensor      # (B, W) last code_0 window (-1 empty)
    n_codes: torch.Tensor   # (B,) codes generated per row
    done: torch.Tensor      # (B,) bool
    codes: torch.Tensor     # (B, T_max, 16) int32 output buffer
    n_text: torch.Tensor    # (B,) text-token counts (EOS pacing)
    budget: torch.Tensor    # (B,) per-row token budget (<= cfg.max_tokens)
    key: torch.Tensor       # (B,) int64 per-row keys (ops/sampling.py)


def prefill_state(talker_params: dict, prefix: torch.Tensor,
                  prefix_len: torch.Tensor, cfg: TTSConfig, kv_dtype=None,
                  mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Talker prefill over a (B, P_pad, H) prefix: (hidden, kv). On a tp
    ``mesh`` the cache holds this rank's kv heads."""
    tcfg = cfg.talker
    kv = tfm.init_kv_cache(tfm.geometry_of(tcfg, mesh), prefix.shape[0],
                           tcfg.max_seq_len, dtype=kv_dtype or prefix.dtype,
                           device=prefix.device)
    return tk.prefill(talker_params, prefix, prefix_len, kv, tcfg, mesh)


def assemble_state(hidden: torch.Tensor, kv, prefix_len: torch.Tensor,
                   n_text: torch.Tensor, key: torch.Tensor, cfg: TTSConfig,
                   budget=None) -> GenState:
    """The per-request loop state around a prefill result; key (B,) int64
    row keys (ops/sampling.batch_keys)."""
    B, dev = hidden.shape[0], hidden.device
    i32 = dict(dtype=torch.int32, device=dev)
    cap = torch.full((B,), cfg.max_tokens, **i32)
    return GenState(
        kv=kv,
        pos=prefix_len.to(torch.int32).reshape(B),
        hidden=hidden,
        ring=torch.full((B, cfg.sampling.repetition_window), -1, **i32),
        n_codes=torch.zeros((B,), **i32),
        done=torch.zeros((B,), dtype=torch.bool, device=dev),
        codes=torch.zeros((B, cfg.max_tokens, 16), **i32),
        n_text=torch.as_tensor(n_text, **i32).reshape(B),
        budget=cap if budget is None else torch.minimum(
            torch.as_tensor(budget, **i32).expand(B), cap),
        key=torch.as_tensor(key, dtype=torch.int64).to(dev).reshape(B),
    )


def init_state(talker_params: dict, prefix: torch.Tensor,
               prefix_len: torch.Tensor, n_text: torch.Tensor,
               key: torch.Tensor, cfg: TTSConfig, kv_dtype=None,
               budget=None, mesh=None) -> GenState:
    """Prefill the talker and build the initial loop state."""
    hidden, kv = prefill_state(talker_params, prefix, prefix_len, cfg,
                               kv_dtype, mesh)
    return assemble_state(hidden, kv, prefix_len, n_text, key, cfg, budget)


def copy_state(state: GenState, **changes) -> GenState:
    """A copy of a dense-cache ``state`` that a decode may update in
    place (``_loop_body`` writes the KV cache and the codes buffer in
    place), with ``changes`` replacing fields: the engine keeps its
    post-prefill snapshots pristine and decodes a copy of one."""
    fields = {f.name: getattr(state, f.name)
              for f in dataclasses.fields(state) if f.name not in changes}
    return GenState(**{k: v.clone() for k, v in fields.items()}, **changes)


def _loop_body(state: GenState, talker_params: dict, cp_params: dict,
               tts_pad_embed: torch.Tensor, cfg: TTSConfig,
               rope_table: Optional[tuple] = None, mesh=None) -> GenState:
    """One token for every row. The KV cache and the codes buffer are
    updated in place; a frozen row rewrites its own slot harmlessly. On a
    tp ``mesh`` the sampled logits are gathered whole, so the codes,
    ``done`` and ``n_codes`` come out equal on every tp rank."""
    B = state.hidden.shape[0]
    scfg = cfg.sampling
    b_idx = torch.arange(B, device=state.hidden.device)

    # 1. code_0 from the current hidden
    logits = tk.codec_logits(talker_params, state.hidden, mesh)
    seeds = smp.token_seeds(state.key, state.n_codes)        # (B, 3)
    code0 = smp.sample_code0(logits, state.ring, state.n_codes,
                             state.n_text, seeds[:, smp.SITE_CODE0], scfg)
    is_eos = (code0 == CODEC_EOS_ID) | (code0 >= NUM_AUDIO_CODES)
    # per-row bound: the dense S, or the row's allocated pages (paged)
    S = tfm.kv_capacity(state.kv)
    has_room = (state.n_codes < state.budget) & (state.pos < S - 1)
    active = ~state.done & ~is_eos & has_room
    act_i = active.to(torch.int32)
    new_n_codes = state.n_codes + act_i
    new_done = (state.done | is_eos | (new_n_codes >= state.budget)
                | (state.pos + act_i >= S - 1))

    # 2. code predictor: groups 1..15 (always computed; masked commit)
    code0_safe = torch.where(active, code0, torch.zeros_like(code0))
    c0_embed = talker_params["codec_embedding"][code0_safe.long()]
    groups = cp.predict_codes(cp_params, state.hidden, c0_embed,
                              seeds[:, smp.SITE_CP_GROUP1:],
                              cfg.code_predictor, scfg, mesh)     # (B, 15)

    # 3. feedback embedding
    embs = cp_params["codec_embs"]
    g_idx = torch.arange(embs.shape[0], device=embs.device)[None, :]
    fb = (c0_embed + embs[g_idx, groups.long()].sum(dim=1)
          + tts_pad_embed[None, :]).to(state.hidden.dtype)

    # 4. talker decode step
    new_hidden, kv = tk.decode_step(talker_params, fb, state.pos, state.kv,
                                    cfg.talker, rope_table=rope_table,
                                    mesh=mesh)

    # 5. commit for active rows only
    row = torch.cat([code0_safe[:, None], groups], dim=1)        # (B, 16)
    write_idx = torch.where(active, state.n_codes.long(),
                            torch.full_like(b_idx, cfg.max_tokens - 1))
    state.codes[b_idx, write_idx] = torch.where(
        active[:, None], row, state.codes[b_idx, write_idx])
    return GenState(
        kv=kv,
        pos=torch.where(active, state.pos + 1, state.pos),
        hidden=torch.where(active[:, None], new_hidden, state.hidden),
        ring=torch.where(active[:, None],
                         smp.ring_push(state.ring, code0_safe), state.ring),
        n_codes=new_n_codes,
        done=new_done,
        codes=state.codes,
        n_text=state.n_text,
        budget=state.budget,
        key=state.key,
    )


def run_steps(talker_params: dict, cp_params: dict, state: GenState,
              cfg: TTSConfig, max_steps: int, mesh=None,
              stats: Optional[dict] = None) -> GenState:
    """Advance the loop by ``max_steps`` tokens, or fewer once every row
    is done. ``done`` is read back only every DONE_CHECK_STRIDE steps
    (each read the span ``done_read``), so up to that many steps past the
    end may run: they change nothing, because every row is frozen.
    ``mesh``: the tp mesh of sharded weights and state; every rank of a
    tp group stops at the same step, as its ``done`` is the same.
    ``stats``, if given, receives the steps run (``steps``), the
    ``done`` reads (``done_reads``) and the steps whose code predictor
    prelude replayed a CUDA graph (``graph_steps``: every step on a card
    off a tp mesh, none elsewhere)."""
    dev = state.hidden.device
    tts_pad_embed = tk.embed_text(
        talker_params, torch.tensor([TTS_PAD_TOKEN_ID], device=dev),
        mesh)[0]
    tcfg = cfg.talker
    rope_table = None
    if not isinstance(state.kv, tfm.PagedKV):
        rope_table = tfm.rope_cos_sin(
            torch.arange(state.kv.shape[3], device=dev), tcfg.head_dim,
            tcfg.rope_theta)
    steps = reads = 0
    for i in range(int(max_steps)):
        if i % DONE_CHECK_STRIDE == 0:
            reads += 1
            with profiling.span("done_read"):
                if bool(state.done.all()):
                    break
        state = _loop_body(state, talker_params, cp_params, tts_pad_embed,
                           cfg, rope_table, mesh)
        steps += 1
    if stats is not None:
        stats.update(steps=steps, done_reads=reads,
                     graph_steps=steps if cp._graphed(dev, mesh) else 0)
    return state


def generate(talker_params: dict, cp_params: dict, prefix: torch.Tensor,
             prefix_len: torch.Tensor, n_text: torch.Tensor,
             key: torch.Tensor, cfg: TTSConfig):
    """Full decode: returns (codes (B, T_max, 16), n_codes (B,))."""
    state = init_state(talker_params, prefix, prefix_len, n_text, key, cfg)
    state = run_steps(talker_params, cp_params, state, cfg, cfg.max_tokens)
    return state.codes, state.n_codes
