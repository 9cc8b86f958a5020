"""The plain reference of Qwen3-TTS-12Hz-0.6B: the talker, the code
predictor, the decode loop's sampling transforms and the FP32 vocoder, in
float32 PyTorch with TF32 off, written from the model's description (HF
Qwen3 blocks: pre-norm RMSNorm, per-head QK-RMSNorm, rotate-half RoPE,
grouped-query attention, SwiGLU; the speech tokenizer's decoder: a
sliding-window causal pre-transformer with LayerScale, ConvNeXt
upsampling, SnakeBeta decoder blocks).

It imports nothing of the program. It takes the weights the benchmark
made (io/weights.py's names and (in, out) layouts) and works out again
whatever the program derives from them: the int8 (or, for the control,
int4) weight-only quantization, the dual-stream prefix, and every hidden
state, by running each request's prompt and served tokens through the
whole model at once (teacher forcing) rather than step by step through a
cache. Weights are taken in float32; a precision below the configured
one quantizes the same weights the program's int8 paths quantize (the
seven projections of every layer, the talker's codec head, the code
predictor's lm heads)."""

from __future__ import annotations

import contextlib
import math
from typing import Tuple

import torch
import torch.nn.functional as F

# special ids (the model's config.json)
CODEC_PAD, CODEC_BOS, CODEC_EOS = 2148, 2149, 2150
CODEC_NOTHINK, CODEC_THINK_BOS, CODEC_THINK_EOS = 2155, 2156, 2157
AUDIO_CODES = 2048
TTS_PAD, TTS_BOS, TTS_EOS = 151671, 151672, 151673
IM_START, ASSISTANT, NEWLINE = 151644, 77091, 198
PREFIX_EXTRA = 9
SAMPLES_PER_TOKEN = 1920
NEG = -1e10
PROJ = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
        "down_proj")


@contextlib.contextmanager
def precision(tf32: bool = False):
    """Matmuls and convolutions in full float32 (TF32 off), or in TF32
    for the vocoder's control."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def quantize(w: torch.Tensor, bits: int) -> torch.Tensor:
    """Symmetric weight-only quantization with one scale per output
    column (the last axis), returned dequantized in float32: w (..., K, N)
    rounded to the nearest of 2 * (2**(bits-1) - 1) + 1 levels of
    amax / (2**(bits-1) - 1)."""
    top = 2 ** (bits - 1) - 1
    wf = w.float()
    amax = wf.abs().amax(dim=-2, keepdim=True)
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return torch.clamp(torch.round(wf / scale), -top, top) * scale


BITS = {"int8": 8, "int4": 4}


def _weight(w: torch.Tensor, mode: str) -> torch.Tensor:
    return quantize(w, BITS[mode]) if mode in BITS else w.float()


def prepare(weights: dict, talker_mode: str, cp_mode: str,
            device) -> Tuple[dict, dict, dict]:
    """Float32 copies of the three components on ``device``, with the
    talker's and the code predictor's quantizable weights at
    ``talker_mode`` / ``cp_mode`` ("bfloat16": as given; "int8", "int4":
    weight-only quantized)."""
    def comp(tree: dict, mode: str, head: str) -> dict:
        out = {}
        for k, v in tree.items():
            if k == "layers":
                out[k] = {n: (_weight(t, mode) if n in PROJ else t.float())
                          .to(device) for n, t in v.items()}
            elif k == head:
                out[k] = _weight(v, mode).to(device)
            elif k == "text_embedding":
                out[k] = v.to(device)     # rows are taken in float32
            else:
                out[k] = v.float().to(device)
        return out

    def f32(tree):
        return {k: f32(v) if isinstance(v, dict) else v.float().to(device)
                for k, v in tree.items()}
    return (comp(weights["talker"], talker_mode, "codec_head"),
            comp(weights["code_predictor"], cp_mode, "lm_heads"),
            f32(weights["vocoder"]))


# -- Qwen3 blocks ----------------------------------------------------------

def rms_norm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x, positions, theta):
    """Rotate-half RoPE; x (B, T, heads, Dh), positions (T,)."""
    Dh = x.shape[-1]
    half = Dh // 2
    inv = 1.0 / (theta ** (torch.arange(half, device=x.device,
                                        dtype=torch.float32) / half))
    ang = positions.float()[:, None] * inv[None, :]
    cos = torch.cat([ang.cos()] * 2, -1)[None, :, None, :]
    sin = torch.cat([ang.sin()] * 2, -1)[None, :, None, :]
    rot = torch.cat([-x[..., half:], x[..., :half]], -1)
    return x * cos + rot * sin


def transformer(layers: dict, x: torch.Tensor, c: dict) -> torch.Tensor:
    """All layers, causal over the T positions 0..T-1 of x (B, T, H);
    returns the hidden before the final norm."""
    B, T, H = x.shape
    nh, nkv, Dh = c["num_heads"], c["num_kv_heads"], c["head_dim"]
    eps = c["rms_norm_eps"]
    pos = torch.arange(T, device=x.device)
    mask = pos[None, :] <= pos[:, None]
    for i in range(layers["input_ln"].shape[0]):
        hn = rms_norm(x, layers["input_ln"][i], eps)
        q = (hn @ layers["q_proj"][i]).view(B, T, nh, Dh)
        k = (hn @ layers["k_proj"][i]).view(B, T, nkv, Dh)
        v = (hn @ layers["v_proj"][i]).view(B, T, nkv, Dh)
        q = rope(rms_norm(q, layers["q_norm"][i], eps), pos, c["rope_theta"])
        k = rope(rms_norm(k, layers["k_norm"][i], eps), pos, c["rope_theta"])
        k = k.repeat_interleave(nh // nkv, dim=2)
        v = v.repeat_interleave(nh // nkv, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(Dh)
        s = s.masked_fill(~mask, float("-inf"))
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
        x = x + o.reshape(B, T, nh * Dh) @ layers["o_proj"][i]
        hn = rms_norm(x, layers["post_ln"][i], eps)
        g = hn @ layers["gate_proj"][i]
        x = x + (F.silu(g) * (hn @ layers["up_proj"][i])) @ \
            layers["down_proj"][i]
    return x


# -- the talker ---------------------------------------------------------

def embed_text(tw: dict, ids: torch.Tensor) -> torch.Tensor:
    e = tw["text_embedding"][ids.long()].float()
    h = F.silu(e @ tw["proj_fc1_w"] + tw["proj_fc1_b"])
    return h @ tw["proj_fc2_w"] + tw["proj_fc2_b"]


def feedback(tw: dict, cw: dict, codes: torch.Tensor,
             tts_pad: torch.Tensor) -> torch.Tensor:
    """The decode loop's input embedding of served tokens (n, 16): the
    talker's codec embedding of code 0, the code predictor's embeddings of
    groups 1..15, and the text stream's pad embedding."""
    g = torch.arange(codes.shape[1] - 1, device=codes.device)
    rest = cw["codec_embs"][g[None, :], codes[:, 1:].long()].sum(1)
    return tw["codec_embedding"][codes[:, 0].long()] + rest + tts_pad


def talker_forward(tw: dict, cw: dict, c: dict, ids: torch.Tensor,
                   codes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The talker over the dual-stream prefix of text ``ids`` (n_text,)
    followed by the served tokens ``codes`` (n, 16). Returns (code-0
    logits (n + 1, V): step t's before any sampling transform, hidden
    (n + 1, H) after the final norm: the code predictor's input of step
    t)."""
    dev = ids.device
    ce = tw["codec_embedding"]
    sp = embed_text(tw, torch.tensor([TTS_PAD, TTS_BOS, TTS_EOS, IM_START,
                                      ASSISTANT, NEWLINE], device=dev))
    pad_e, bos_e, eos_e, role = sp[0], sp[1], sp[2], sp[3:6]
    think = pad_e + ce[torch.tensor([CODEC_NOTHINK, CODEC_THINK_BOS,
                                     CODEC_THINK_EOS], device=dev)]
    rows = [role, think, (bos_e + ce[CODEC_PAD])[None],
            embed_text(tw, ids) + ce[CODEC_PAD],
            (eos_e + ce[CODEC_PAD])[None], (pad_e + ce[CODEC_BOS])[None],
            feedback(tw, cw, codes, pad_e)]
    x = torch.cat(rows, 0)[None]
    h = rms_norm(transformer(tw["layers"], x, c)[0], tw["final_norm"],
                 c["rms_norm_eps"])
    P = len(ids) + PREFIX_EXTRA
    hid = h[P - 1:]
    return hid @ tw["codec_head"], hid


def code0_scores(logits: torch.Tensor, code0: torch.Tensor, n_text: int,
                 s: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """The code-0 policy's deterministic transforms at every step t of the
    served sequence: audio codes and EOS only, the EOS boost of progress
    t / (n_text * expected), the repetition penalty over the last
    ``repetition_window`` served codes. Returns (scores (T, V), forced EOS
    (T,) bool); greedy decoding takes the first maximum."""
    T, V = logits.shape
    dev = logits.device
    idx = torch.arange(V, device=dev)
    allowed = (idx < AUDIO_CODES) | (idx == CODEC_EOS)
    x = torch.where(allowed, logits, torch.full_like(logits, NEG))
    t = torch.arange(T, device=dev, dtype=torch.float32)
    expected = float(n_text * s["expected_tokens_per_text_token"])
    progress = t / expected if expected > 0 else torch.zeros_like(t)
    ramp = torch.clamp((progress - s["eos_boost_start"])
                       / s["eos_boost_ramp"], max=1.0) * s["eos_boost_max"]
    x[:, CODEC_EOS] += torch.where(progress > s["eos_boost_start"], ramp,
                                   torch.zeros_like(ramp))
    W = s["repetition_window"]
    member = torch.zeros((T, V), dtype=torch.bool, device=dev)
    c0 = code0.long()
    for j in range(T):
        prev = c0[max(0, j - W):j]
        if len(prev):
            member[j, prev] = True
    pen = s["repetition_penalty"]
    x = torch.where(member, torch.where(x > 0, x / pen, x * pen), x)
    return x, progress > s["eos_force_progress"]


# -- the code predictor ---------------------------------------------------

def cp_logits(cw: dict, tw: dict, c: dict, hidden: torch.Tensor,
              codes: torch.Tensor) -> torch.Tensor:
    """Group logits (n, 15, Vg) of served tokens: per token, the 16
    positions [talker hidden, codec embedding of code 0, embeddings of
    groups 1..14] through the mtp projection and the layers; group g's
    logits from position g and lm head g - 1."""
    n = codes.shape[0]
    G = c["num_groups"]
    g = torch.arange(G - 1, device=codes.device)
    embs = cw["codec_embs"][g[None, :], codes[:, 1:G].long()]   # (n, 14, H)
    x = torch.cat([hidden[:, None], tw["codec_embedding"][
        codes[:, 0].long()][:, None], embs], 1)
    x = x @ cw["mtp_proj_w"] + cw["mtp_proj_b"]
    h = rms_norm(transformer(cw["layers"], x, c), cw["final_norm"],
                 c["rms_norm_eps"])
    return torch.einsum("ngh,ghv->ngv", h[:, 1:G + 1], cw["lm_heads"])


# -- the vocoder (speech tokenizer decoder) -------------------------------

def snake(x, a, b):
    s = torch.sin(x * torch.exp(a))
    return x + s * s / (torch.exp(b) + 1e-9)


def conv(x, w, b, dilation=1, groups=1):
    """Causal conv, x (B, T, Cin), w (K, Cin/groups, Cout)."""
    k = (w.shape[0] - 1) * dilation + 1
    y = F.conv1d(F.pad(x.transpose(1, 2), (k - 1, 0)), w.permute(2, 1, 0), b,
                 dilation=dilation, groups=groups)
    return y.transpose(1, 2)


def trans_conv(x, w, b, stride):
    """Transposed conv cropped by k - stride on both sides; w is stored
    spatially flipped, (K, Cin, Cout)."""
    k = w.shape[0]
    y = F.conv_transpose1d(x.transpose(1, 2),
                           torch.flip(w, (0,)).permute(1, 2, 0), b,
                           stride=stride)
    crop = max(k - stride, 0)
    if crop:
        y = y[:, :, crop:y.shape[2] - crop]
    return y.transpose(1, 2)


def vocoder(vw: dict, v: dict, codes: torch.Tensor) -> torch.Tensor:
    """codes (T, 16) -> waveform f32 in [-1, 1], (T * 1920 - crop,)."""
    T = codes.shape[0]
    H, nh = v["hidden_size"], v["num_attention_heads"]
    Dh = H // nh
    off = torch.arange(codes.shape[1], device=codes.device) * \
        v["codebook_size"]
    x = vw["code_embedding"][codes.long() + off].mean(1)[None]   # (1, T, H)
    pre, eps = vw["pre"], v["rms_norm_eps"]
    lay = pre["layers"]
    pos = torch.arange(T, device=codes.device)
    mask = (pos[None, :] <= pos[:, None]) & \
        (pos[:, None] - pos[None, :] < v["sliding_window"])
    for i in range(lay["input_ln"].shape[0]):
        hn = rms_norm(x, lay["input_ln"][i], eps)
        q = rope((hn @ lay["q_proj"][i]).view(1, T, nh, Dh), pos,
                 v["rope_theta"])
        k = rope((hn @ lay["k_proj"][i]).view(1, T, nh, Dh), pos,
                 v["rope_theta"])
        vv = (hn @ lay["v_proj"][i]).view(1, T, nh, Dh)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(Dh)
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(
            s.masked_fill(~mask, float("-inf")), -1), vv)
        x = x + lay["attn_scale"][i] * (o.reshape(1, T, H) @ lay["o_proj"][i])
        hn = rms_norm(x, lay["post_ln"][i], eps)
        m = (F.silu(hn @ lay["gate_proj"][i]) * (hn @ lay["up_proj"][i])) \
            @ lay["down_proj"][i]
        x = x + lay["mlp_scale"][i] * m
    x = rms_norm(x, pre["norm"], eps)
    for i, f in enumerate(v["upsampling_ratios"]):
        u = vw["upsample"][str(i)]
        x = trans_conv(x, u["up_w"], u["up_b"], f)
        h = conv(x, u["cn_dw_w"], u["cn_dw_b"], groups=x.shape[-1])
        h = F.layer_norm(h, (h.shape[-1],), u["cn_ln_w"], u["cn_ln_b"], 1e-6)
        h = F.gelu(h @ u["cn_pw1_w"] + u["cn_pw1_b"]) @ u["cn_pw2_w"] + \
            u["cn_pw2_b"]
        x = x + u["cn_gamma"] * h
    x = conv(x, vw["dec_in_w"], vw["dec_in_b"])
    for i, r in enumerate(v["upsample_rates"]):
        blk = vw["blocks"][str(i)]
        x = trans_conv(snake(x, blk["alpha"], blk["beta"]), blk["up_w"],
                       blk["up_b"], r)
        for d, dil in enumerate((1, 3, 9)):
            ru = blk["res"][str(d)]
            h = conv(snake(x, ru["alpha1"], ru["beta1"]), ru["conv1_w"],
                     ru["conv1_b"], dilation=dil)
            x = x + conv(snake(h, ru["alpha2"], ru["beta2"]), ru["conv2_w"],
                         ru["conv2_b"])
    x = conv(snake(x, vw["out_alpha"], vw["out_beta"]), vw["out_w"],
             vw["out_b"])
    return torch.clamp(x[0, :, 0], -1.0, 1.0)


def vocode_int16(vw: dict, v: dict, codes: torch.Tensor,
                 tf32: bool = False) -> torch.Tensor:
    """int16 samples (n * 1920,) of served tokens (n, 16): the tokens and
    one zero-code token of lookahead, padded with zero codes to a whole
    64-token window, decoded, cut to n tokens, scaled by 32767 and
    truncated as the program's int16 conversion does."""
    n = codes.shape[0]
    W = -(-(n + 1) // 64) * 64
    padded = torch.zeros((W, codes.shape[1]), dtype=codes.dtype,
                         device=codes.device)
    padded[:n] = codes
    with precision(tf32):
        wav = vocoder(vw, v, padded)[:n * SAMPLES_PER_TOKEN]
    return torch.clamp(wav * 32767.0, -32768.0, 32767.0).to(torch.int16)


def step_count(n: int, budget: int) -> int:
    """Steps whose code 0 was drawn: the n served tokens, and the EOS step
    when the request ended before its budget."""
    return n + 1 if n < budget else n


def greedy_choice(scores: torch.Tensor) -> torch.Tensor:
    return torch.argmax(scores, dim=-1)

