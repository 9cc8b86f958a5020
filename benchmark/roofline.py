"""The yardstick's arithmetic: the card's published peaks, the least time
of a call of each hand-written kernel on the timed path (its inputs read
once and its outputs written once, at the call's rows, against 3.35 TB/s,
or its operations against the peak, whichever is longer), and the model's
operations for the work a run completed, from the configuration's shapes.

The byte models are frozen copies, computed here from the configuration
instead of from tensors, of ``bound_bytes`` and ``read_bytes`` in
qwen3_tts_tpu_torch/tools/bench_talker_step.py (K3), ``step_bytes`` in
tools/bench_cp_decode.py (K2; here every input once a call, not once a
step) and ``bound_ms`` in tools/bench_decode_attention.py (K4)."""

from __future__ import annotations

# NVIDIA H100 SXM, published (dense, no sparsity)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12


def _dims(c: dict):
    H, I, Dh = c["hidden_size"], c["intermediate_size"], c["head_dim"]
    return H, I, c["num_heads"] * Dh, c["num_kv_heads"] * Dh, Dh


def layer_params(c: dict) -> int:
    """Weights of one layer's seven projections."""
    H, I, QD, KVD, _ = _dims(c)
    return H * (QD + 2 * KVD) + QD * H + 3 * H * I


def layer_scales(c: dict) -> int:
    """Per-channel scales of one int8 layer (one an output column)."""
    H, I, QD, KVD, _ = _dims(c)
    return (QD + 2 * KVD) + H + 2 * I + H


def least_s(n_bytes: float, flops: float, peak: float = BF16_FLOPS) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, flops / peak)


def k3_call(t: dict, B: int, kv_rows: float) -> tuple:
    """K3 (the int8 talker step, all layers) over B rows that read
    ``kv_rows`` K/V positions in all: (bytes, operations). Bytes: the int8
    weights and f32 scales, the bf16 norms, x in and h out in bf16, the
    bf16 K/V rows 0..pos of every layer, the fresh K/V rows out in f32."""
    L, H, Dh = t["num_layers"], t["hidden_size"], t["head_dim"]
    Hkv = t["num_kv_heads"]
    w = L * (layer_params(t) + 4 * layer_scales(t))
    norms = L * (2 * H + 2 * Dh) * 2
    kv = L * 2 * kv_rows * Hkv * Dh * 2
    out_rows = L * 2 * B * Hkv * Dh * 4
    n_bytes = w + norms + 2 * B * H * 2 + kv + out_rows
    flops = (2 * B * L * layer_params(t)
             + 4 * kv_rows * t["num_heads"] * Dh * L)
    return n_bytes, flops


def k2_call(c: dict, B: int) -> tuple:
    """K2 (the code predictor's 14 steps after its 2-token prefill) over
    B rows: (bytes, operations). Bytes: the int8 layer stack and its
    scales, lm heads 1..14 and their scales, the bf16 mtp projection and
    norms, the B x 14 codec-embedding rows it looks up, the bf16 K/V of
    the two prefill positions, the rope tables, tokens and seeds in, the
    14 x B tokens out."""
    L, H, Dh, S = c["num_layers"], c["hidden_size"], c["head_dim"], \
        c["max_seq_len"]
    V, steps = c["group_vocab_size"], c["num_groups"] - 1
    Hkv = c["num_kv_heads"]
    stack = L * (layer_params(c) + 4 * layer_scales(c))
    heads = steps * (H * V + 4 * V)
    mtp = (H * H + H) * 2
    norms = (L * (2 * H + 2 * Dh) + H) * 2
    embs = B * steps * H * 2
    kv = L * 2 * B * 2 * Hkv * Dh * 2
    rope = 2 * S * Dh * 4
    n_bytes = (stack + heads + mtp + norms + embs + kv + rope + 2 * B * 4
               + steps * B * 4)
    flops = 2 * B * steps * (L * layer_params(c) + H * H + H * V)
    return n_bytes, flops


def k4_call(t: dict, B: int, kv_rows: float, max_pages: int) -> tuple:
    """K4 (paged decode attention, one layer) over B rows that read
    ``kv_rows`` positions in all: (bytes, operations). Bytes: q, pos, the
    bf16 K and V rows 0..pos, the page table, the output; 4 operations per
    K/V element (at the f32 peak, as its bound in tools/
    bench_decode_attention.py)."""
    Hq, Hkv, Dh = t["num_heads"], t["num_kv_heads"], t["head_dim"]
    n_bytes = (B * Hq * Dh * 2 + B * 4 + 2 * kv_rows * Hkv * Dh * 2
               + B * max_pages * 4 + B * Hq * Dh * 2)
    return n_bytes, 4.0 * kv_rows * Hq * Dh


def attention_flops(c: dict, q_pos_sum: float) -> float:
    """QK and PV over causal keys, summed over queries: q_pos_sum is the
    sum over queries of their key counts."""
    return 4.0 * q_pos_sum * c["num_heads"] * c["head_dim"] * c["num_layers"]


def talker_cp_flops(cfg: dict, n_text: int, n_codes: int,
                    steps: int) -> float:
    """The talker's and the code predictor's operations for one finished
    request: the text projection of its prefix, the prefill of its n_text
    + 9 rows, ``steps`` code-0 heads (the served tokens and the EOS step),
    and for each served token the code predictor's 16 positions with its
    mtp projection and 15 lm heads, then one talker step."""
    t, c = cfg["talker"], cfg["code_predictor"]
    E, H = t["text_embed_dim"], t["hidden_size"]
    P = n_text + 9
    text = 2 * (n_text + 6) * (E * E + E * H)
    prefill = (2 * P * t["num_layers"] * layer_params(t)
               + attention_flops(t, P * (P + 1) / 2))
    kv_sum = sum(P + i + 1 for i in range(n_codes))
    decode = (2 * n_codes * t["num_layers"] * layer_params(t)
              + attention_flops(t, kv_sum))
    head = 2 * steps * H * t["codec_vocab_size"]
    G = c["num_groups"] + 1
    Hc = c["hidden_size"]
    cp = n_codes * (2 * G * c["num_layers"] * layer_params(c)
                    + attention_flops(c, G * (G + 1) / 2)
                    + 2 * G * Hc * Hc
                    + 2 * c["num_groups"] * Hc * c["group_vocab_size"])
    return text + prefill + decode + head + cp


def vocoder_flops(v: dict, n_tokens: int) -> float:
    """The FP32 decoder's operations for n_tokens tokens: the
    pre-transformer (its sliding window at full context), the ConvNeXt
    upsampling stages, the input conv, the decoder blocks and the output
    conv, each conv at its own frame rate."""
    H, I, L = v["hidden_size"], v["intermediate_size"], v["num_hidden_layers"]
    w = min(v["sliding_window"], max(n_tokens, 1))
    per = L * (2 * (4 * H * H + 3 * H * I) + 4 * w * H)
    r = 1
    for f in v["upsampling_ratios"]:
        per += 2 * f * H * H * r                  # transposed conv
        r *= f
        per += r * (2 * 7 * H + 2 * 8 * H * H)    # depthwise, two pointwise
    D = v["decoder_dim"]
    per += r * 2 * 7 * H * D
    cin = D
    for i, rate in enumerate(v["upsample_rates"]):
        cout = D // (2 ** (i + 1))
        per += r * 2 * (2 * rate) * cin * cout
        r *= rate
        per += r * 3 * 2 * (7 * cout * cout + cout * cout)
        cin = cout
    per += r * 2 * 7 * cin
    return float(per) * n_tokens
