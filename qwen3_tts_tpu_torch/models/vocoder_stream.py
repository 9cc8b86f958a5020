"""Incremental (stateful) streaming vocoder: O(new tokens) per emission.
Twin of qwen3_tts_tpu/models/vocoder_stream.py.

The chunked paths of models/vocoder.py re-decode a window with its full
left context for every emission (O(end) a window). This module carries
the decoder's state across emissions instead, so a chunk costs O(new
tokens) wherever it sits, and stays sample-exact against
``vocoder.decode_raw`` up to a GEMM's summation order (f32 <= 1e-6
absolute; int16 within +-1 LSB on < 0.01% of samples on the CPU: the
attention over [KV window + chunk] keys adds up in another order than the
full-sequence forward; the conv path alone is bitwise):

- **pre-transformer**: a rolling per-layer KV window of the last
  ``sliding_window - 1`` frames (keys rotated at their absolute
  positions), which is exactly what sliding-window causal attention
  reads.
- **causal convs** (stride 1): the last ``(k - 1) * dilation`` input
  frames. Zero tails reproduce the full decode's left zero padding.
- **causal transposed convs** of the waveform decoder (k = 2r, s = r,
  crop r): output frame j needs input frames j // r and j // r + 1, one
  frame of lookahead, so the stream holds the last input frame back and
  prepends it to the next chunk. The 2x ConvNeXt upconvs (k = s = 2,
  crop 0) are frame-pointwise and need no state.

The held-back frames give the stream a constant lag of ``cfg.output_crop``
samples: a first (unprimed) step over c frames emits c * 1920 -
output_crop samples, every later step c * 1920. A final step over zero
codes past the utterance's end flushes the lag, the zero-code lookahead
of ``synthesize_exact``.

The state is a dict of f32 tensors on the vocoder's device plus ``pos``,
the absolute frame position, a host int: the rotary tables and the
window's validity mask are built from it without reading the device.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from qwen3_tts_tpu_torch.config import SAMPLES_PER_TOKEN, VocoderConfig
from qwen3_tts_tpu_torch.models import transformer as tfm
from qwen3_tts_tpu_torch.models import vocoder as voc

State = Dict[str, object]


def init_stream_state(cfg: VocoderConfig, batch: int = 1,
                      device="cuda") -> State:
    """Zero state for a new stream: zero conv tails (the full decode's
    causal left padding), an empty KV window (masked invalid through
    ``pos``), transposed-conv hold-backs unused until primed."""
    H = cfg.hidden_size
    L = cfg.num_hidden_layers
    Hh, Dh = cfg.num_attention_heads, cfg.head_dim
    Wc = cfg.sliding_window - 1
    D = cfg.decoder_dim

    def z(*s):
        return torch.zeros(s, dtype=torch.float32, device=device)

    state: State = {
        "pos": 0,
        # rotated K and V of the last Wc frames, per layer
        "pre_kv": z(L, 2, batch, Wc, Hh, Dh),
        "up": {str(i): {"dw_tail": z(batch, 6, H)}
               for i in range(len(cfg.upsampling_ratios))},
        "dec_in_tail": z(batch, 6, H),
        "blocks": {},
    }
    cin = D
    for i, _r in enumerate(cfg.upsample_rates):
        cout = D // (2 ** (i + 1))
        state["blocks"][str(i)] = {
            "held": z(batch, 1, cin),
            "res": {str(d_i): {"t1": z(batch, 6 * dil, cout)}
                    for d_i, dil in enumerate((1, 3, 9))},
        }
        cin = cout
    state["out_tail"] = z(batch, 6, cin)
    return state


def _conv_stream(x: torch.Tensor, tail: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor, *, dilation: int = 1,
                 groups: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stride-1 causal conv continued over [tail, x] with no padding: the
    same dot products as the full causal conv's outputs at these
    positions. tail (B, (k - 1) * dilation, C); w WIO (K, Cin/groups,
    Cout)."""
    k = w.shape[0]
    inp = torch.cat([tail, x], dim=1) if k > 1 else x
    out = F.conv1d(inp.transpose(1, 2), w.permute(2, 1, 0), b,
                   dilation=dilation, groups=groups).transpose(1, 2)
    return out, (inp[:, -(k - 1) * dilation:] if k > 1 else tail)


def _trans_conv_stream(x: torch.Tensor, held: torch.Tensor,
                       w: torch.Tensor, b: torch.Tensor, *, stride: int,
                       primed: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal transposed conv continued (k = 2r, s = r, crop r): with the
    previous chunk's last input frame prepended, causal_trans_conv1d
    emits exactly the next m * r output frames. Unprimed (the first
    chunk) it emits (m - 1) * r and holds the last frame back."""
    inp = torch.cat([held, x], dim=1) if primed else x
    out = voc.causal_trans_conv1d(inp, w, b, stride=stride)
    return out, inp[:, -1:]


def _pre_transformer_stream(p: dict, x: torch.Tensor, kv: torch.Tensor,
                            pos: int, cfg: VocoderConfig
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Incremental sliding-window attention. x (B, c, H): new frames at
    absolute positions [pos, pos + c); kv (L, 2, B, Wc, Hh, Dh): rotated
    keys and values of frames [pos - Wc, pos) (slots below 0 invalid).
    Each query attends to exactly the keys the full forward's mask
    admits, in the same order."""
    B, c, H = x.shape
    Hh, Dh = cfg.num_attention_heads, cfg.head_dim
    Wc = cfg.sliding_window - 1
    eps = cfg.rms_norm_eps
    dev = x.device
    qpos = pos + torch.arange(c, device=dev)
    kpos = torch.cat([pos - Wc + torch.arange(Wc, device=dev), qpos])
    # vocoder.pre_transformer's window: 0 <= i - j < sliding_window
    mask = ((kpos[None, :] >= 0) & (kpos[None, :] <= qpos[:, None])
            & (qpos[:, None] - kpos[None, :] < cfg.sliding_window))
    cos, sin = tfm.rope_cos_sin(qpos, Dh, cfg.rope_theta)
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    layers = p["layers"]
    new_kv = []
    for l in range(layers["input_ln"].shape[0]):
        lp = {k: v[l] for k, v in layers.items()}
        hn = tfm.rms_norm(x, lp["input_ln"], eps)
        q = tfm.apply_rope((hn @ lp["q_proj"]).reshape(B, c, Hh, Dh),
                           cos, sin)
        k = tfm.apply_rope((hn @ lp["k_proj"]).reshape(B, c, Hh, Dh),
                           cos, sin)
        v = (hn @ lp["v_proj"]).reshape(B, c, Hh, Dh)
        k_all = torch.cat([kv[l, 0], k], dim=1)           # (B, Wc + c, ...)
        v_all = torch.cat([kv[l, 1], v], dim=1)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k_all) * Dh ** -0.5
        logits = logits.masked_fill(~mask, -float("inf"))
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1),
                         v_all)
        x = x + lp["attn_scale"] * (o.reshape(B, c, H) @ lp["o_proj"])
        hn = tfm.rms_norm(x, lp["post_ln"], eps)
        m = (F.silu(hn @ lp["gate_proj"]) * (hn @ lp["up_proj"])) \
            @ lp["down_proj"]
        x = x + lp["mlp_scale"] * m
        new_kv.append(torch.stack([k_all[:, -Wc:], v_all[:, -Wc:]]))
    return tfm.rms_norm(x, p["norm"], eps), torch.stack(new_kv)


def stream_step(params: dict, state: State, codes: torch.Tensor,
                cfg: VocoderConfig, *,
                primed: bool) -> Tuple[torch.Tensor, State]:
    """Advance the stream by ``codes`` (B, c, 16) int frames.

    Returns (audio, new_state): audio (B, c * total_upsample) f32 when
    ``primed``, (B, c * total_upsample - output_crop) on the first
    (unprimed) call. Feed zero codes after the last real frame to flush
    the lag and trim the concatenated stream to n_real * total_upsample
    samples. Runs with TF32 off, as vocoder.decode_raw."""
    with voc._fp32_exact():
        codes = codes.long()
        B, c, NQ = codes.shape
        ns: State = {}
        offsets = torch.arange(NQ, device=codes.device) * cfg.codebook_size
        x = params["code_embedding"][codes + offsets].float().mean(dim=2)
        x, ns["pre_kv"] = _pre_transformer_stream(
            params["pre"], x, state["pre_kv"], state["pos"], cfg)
        ns["pos"] = state["pos"] + c

        ns["up"] = {}
        for i, f in enumerate(cfg.upsampling_ratios):
            up = params["upsample"][str(i)]
            # k = s = f = 2, crop 0: frame-pointwise, stateless
            x = voc.causal_trans_conv1d(x, up["up_w"], up["up_b"], stride=f)
            h, dw_tail = _conv_stream(x, state["up"][str(i)]["dw_tail"],
                                      up["cn_dw_w"], up["cn_dw_b"],
                                      groups=x.shape[-1])
            h = voc.layer_norm(h, up["cn_ln_w"], up["cn_ln_b"], 1e-6)
            h = F.gelu(h @ up["cn_pw1_w"] + up["cn_pw1_b"],
                       approximate="none")
            h = h @ up["cn_pw2_w"] + up["cn_pw2_b"]
            x = x + up["cn_gamma"] * h
            ns["up"][str(i)] = {"dw_tail": dw_tail}

        x, ns["dec_in_tail"] = _conv_stream(x, state["dec_in_tail"],
                                            params["dec_in_w"],
                                            params["dec_in_b"])
        ns["blocks"] = {}
        for i, rate in enumerate(cfg.upsample_rates):
            bp = params["blocks"][str(i)]
            bs = state["blocks"][str(i)]
            nbs: State = {"res": {}}
            h = voc.snake_beta(x, bp["alpha"], bp["beta"])
            h, nbs["held"] = _trans_conv_stream(h, bs["held"], bp["up_w"],
                                                bp["up_b"], stride=rate,
                                                primed=primed)
            for d_i, dil in enumerate((1, 3, 9)):
                rp = bp["res"][str(d_i)]
                u = voc.snake_beta(h, rp["alpha1"], rp["beta1"])
                u, t1 = _conv_stream(u, bs["res"][str(d_i)]["t1"],
                                     rp["conv1_w"], rp["conv1_b"],
                                     dilation=dil)
                u = voc.snake_beta(u, rp["alpha2"], rp["beta2"])
                u, _ = _conv_stream(u, u[:, :0], rp["conv2_w"],
                                    rp["conv2_b"])
                h = h + u
                nbs["res"][str(d_i)] = {"t1": t1}
            x = h
            ns["blocks"][str(i)] = nbs

        x = voc.snake_beta(x, params["out_alpha"], params["out_beta"])
        x, ns["out_tail"] = _conv_stream(x, state["out_tail"],
                                         params["out_w"], params["out_b"])
        return torch.clamp(x[:, :, 0], -1.0, 1.0), ns


class Segment:
    """The int16 samples of one stream step, on the device until fetched:
    samples [start, start + length) of its utterance's stream."""

    def __init__(self, audio: torch.Tensor, start: int, length: int):
        self.audio, self.start, self.length = audio, start, length

    def fetch(self) -> np.ndarray:
        """All of the step's samples on the host (copied once)."""
        if isinstance(self.audio, torch.Tensor):
            self.audio = self.audio.cpu().numpy()
        return self.audio

    def take(self, n_tokens: int) -> np.ndarray:
        """The samples that lie within the utterance's first ``n_tokens``
        tokens, on the host; a flush step's overshoot is trimmed, and a
        step wholly past them is not fetched."""
        keep = min(self.length,
                   max(n_tokens * SAMPLES_PER_TOKEN - self.start, 0))
        if keep <= 0:
            return np.zeros((0,), np.int16)
        return self.fetch()[:keep]


class Stream:
    """One utterance's place in its stream: the state (None until the
    first step), the code frames fed so far and the samples emitted."""

    def __init__(self):
        self.state = None
        self.frames = 0
        self.samples = 0


class StreamStepper:
    """Fixed-size incremental stream steps, shared by the engine's
    streaming synthesis and the batcher's ``on_chunk`` emissions.

    Any emission extent decomposes into ``SIZES`` quanta (plan_quanta).
    A step slices ``c`` code frames from a codes row at a host ``start``
    (rows past the row's end read as zeros: a flush step may overshoot
    the utterance, the zero-code lookahead of synthesize_exact), advances
    the stream state and returns int16 samples, converted on the
    device. ``advance`` holds the policy both callers share."""

    SIZES = (64, 32, 16, 8)

    def __init__(self, cfg_v: VocoderConfig):
        self.cfg = cfg_v
        self._fns = {}

    def advance(self, vp: dict, row: torch.Tensor, stream: Stream,
                end: int, final: bool) -> List[Segment]:
        """Launch the steps that feed ``stream`` the frames of the device
        codes ``row`` (T, 16) up to token ``end``; nothing is read back.
        Not ``final``: the frames [stream.frames, end) are final, and
        whole quanta of them are fed, the sub-quantum rest waiting for
        more. ``final``: the utterance ends at ``end`` tokens; the rest
        and at least one zero-code frame past it are fed, which flushes
        the stream's lag, and the segments are trimmed to ``end`` tokens
        when taken. The first (unprimed) step of a stream emits c * 1920
        - output_crop samples, every later one c * 1920."""
        need = end + 1 - stream.frames if final else end - stream.frames
        if end <= 0 or need <= 0:
            return []
        crop = self.cfg.output_crop
        segs = []
        for c in self.plan_quanta(need, final):
            primed = stream.frames > 0
            if stream.state is None:
                stream.state = init_stream_state(self.cfg,
                                                 device=row.device)
            out, stream.state = self.step_fn(c, primed)(
                vp, row, stream.frames, stream.state)
            length = c * SAMPLES_PER_TOKEN - (0 if primed else crop)
            segs.append(Segment(out[0], stream.samples, length))
            stream.frames += c
            stream.samples += length
        return segs

    def step_fn(self, c: int, primed: bool):
        """The step over ``c`` frames: fn(vp, codes_row (T, 16), start,
        state) -> (int16 audio (1, out_len) on the device, new state).
        One plain function a (c, primed), cached."""
        key = (c, primed)
        fn = self._fns.get(key)
        if fn is None:
            cfg_v = self.cfg

            def step(vp, codes_row, start: int, st):
                chunk = codes_row[start:start + c].to(torch.int32)
                if chunk.shape[0] < c:
                    chunk = F.pad(chunk, (0, 0, 0, c - chunk.shape[0]))
                audio, st2 = stream_step(vp, st, chunk[None], cfg_v,
                                         primed=primed)
                return voc.to_int16_device(audio), st2

            fn = self._fns[key] = step
        return fn

    def plan_quanta(self, n_frames: int, overshoot: bool) -> List[int]:
        """Quanta covering ``n_frames``. With ``overshoot`` the last
        quantum may read past the end (zero rows: the final flush of a
        finished utterance); without it the sub-quantum remainder waits
        until more frames are final."""
        plan = []
        if overshoot:
            need = n_frames
            while need > 0:
                s = min((s for s in self.SIZES if s >= need),
                        default=max(self.SIZES))
                plan.append(s)
                need -= s
        else:
            avail = n_frames
            floor = min(self.SIZES)
            while avail >= floor:
                s = max(s for s in self.SIZES if s <= avail)
                plan.append(s)
                avail -= s
        return plan
