// K3: the whole talker decode step (all layers) for 1 <= B <= 8 rows.
//
// Replaces the TPU kernel qwen3_tts_tpu/ops/pallas/talker_step.py ::
// talker_decode_step_fused.
//
// Per layer: f32 RMSNorm -> fused int8 q|k|v -> per-head QK-RMSNorm ->
// RoPE at pos -> GQA attention over the layer's dense KV with the fresh
// row substituted at pos -> int8 o_proj + residual -> RMSNorm -> fused
// int8 gate|up -> SiLU * up -> int8 down + residual. The residual h is
// carried in f32 across layers; the operands of each int8 product are
// bf16; q/k norms and RoPE are f32; K/V are read as bf16; scores and the
// softmax are f32 and p is rounded to bf16 before P.V. Output: h (B, H)
// through bf16 (pre-final-norm) and the fresh K/V rows (L, 2, B, nKV, Dh)
// in f32, which the caller scatters into the cache.
//
// Bound on an H100: at B <= 8 a step streams the int8 weights once
// (28 layers x 15.7 MB at the 0.6B geometry, 440 MB) plus the KV read
// (at most 512 rows x 8 heads x 128 x 2 x 2 bytes per layer, bf16), at
// ~2 flops per weight byte: bound by HBM bandwidth, not by the tensor
// cores. The design reads each weight byte once per step in its int8
// form (the qmm tiles of common.cuh, 32-byte sectors per weight row, N/32
// blocks per product) and never writes the KV stream back. Each layer is
// a fixed sequence of five launches (qkv, attention, o_proj, gate|up,
// down); a grid-wide persistent version that overlaps the layers is
// later work.
#include "common.cuh"

namespace {

constexpr int V_TILE = 32;  // V rows staged in shared memory per P.V pass

// one block per (query head, row)
__global__ void __launch_bounds__(ATT_THREADS)
talker_attn_kernel(const float* qkv, const void* qn, const void* kn,
                   int nw_bf16, const float* cos_t, const float* sin_t,
                   const int* pos, const void* kv, int kv_bf16,
                   __nv_bfloat16* attn, float* rows, int B, int S, int nH,
                   int nKV, int Dh, float eps, float scale) {
  extern __shared__ float sm[];
  float* qrow = sm;               // Dh
  float* krow = qrow + Dh;        // Dh
  float* vrow = krow + Dh;        // Dh
  float* tmp = vrow + Dh;         // Dh
  float* red = tmp + Dh;          // 32
  float* vt = red + 32;           // V_TILE * Dh
  float* sc = vt + V_TILE * Dh;   // S
  const int hq = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int G = nH / nKV, h = hq / G;
  const int QD = nH * Dh, KVD = nKV * Dh, ld = QD + 2 * KVD;
  const int p = pos[b];
  const bool act = d < Dh;
  const float c = act ? cos_t[(long)p * Dh + d] : 0.f;
  const float s = act ? sin_t[(long)p * Dh + d] : 0.f;

  // q: f32 RMS (q_norm) then RoPE
  float x = act ? qkv[(long)b * ld + hq * Dh + d] : 0.f;
  float inv = rms_scale(block_sum(__fmul_rn(x, x), red), Dh, eps);
  if (act) tmp[d] = rms_apply(x, inv, ldf(qn, d, nw_bf16));
  __syncthreads();
  if (act) qrow[d] = bf16r(rope_at(tmp, d, Dh, c, s));
  __syncthreads();
  // fresh k: f32 RMS (k_norm) then RoPE; v raw
  x = act ? qkv[(long)b * ld + QD + h * Dh + d] : 0.f;
  inv = rms_scale(block_sum(__fmul_rn(x, x), red), Dh, eps);
  if (act) tmp[d] = rms_apply(x, inv, ldf(kn, d, nw_bf16));
  __syncthreads();
  const float knew = act ? rope_at(tmp, d, Dh, c, s) : 0.f;
  const float vnew = act ? qkv[(long)b * ld + QD + KVD + h * Dh + d] : 0.f;
  if (act) {
    krow[d] = bf16r(knew);
    vrow[d] = bf16r(vnew);
  }
  if (act && hq % G == 0) {
    rows[(((long)0 * B + b) * nKV + h) * Dh + d] = knew;
    rows[(((long)1 * B + b) * nKV + h) * Dh + d] = vnew;
  }
  __syncthreads();

  // scores over s <= p: one warp per position, lanes over Dh
  const long kbase = (long)b * S * KVD + h * Dh;            // K[b, s, h, :]
  const long vbase = (long)B * S * KVD + kbase;             // V[b, s, h, :]
  const int warp = d >> 5, lane = d & 31, nw = ATT_THREADS / 32;
#pragma unroll 4
  for (int si = warp; si <= p; si += nw) {
    float acc = 0.f;
    for (int j = lane; j < Dh; j += 32) {
      const float kv_ = si == p ? krow[j]
                                : bf16r(ldf(kv, kbase + (long)si * KVD + j,
                                            kv_bf16));
      acc = fmaf(qrow[j], kv_, acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) sc[si] = __fmul_rn(acc, scale);
  }
  __syncthreads();
  float m = -INFINITY;
  for (int si = d; si <= p; si += ATT_THREADS) m = fmaxf(m, sc[si]);
  m = block_max(m, red);
  float tot = 0.f;
  for (int si = d; si <= p; si += ATT_THREADS) {
    const float e = expf(sc[si] - m);
    sc[si] = e;
    tot += e;
  }
  tot = block_sum(tot, red);  // syncs, so every sc[] is written
  for (int si = d; si <= p; si += ATT_THREADS)
    sc[si] = bf16r(__fdiv_rn(sc[si], tot));  // p, rounded to bf16
  // P.V: the block stages V_TILE rows of V (bf16, the fresh row at p) in
  // shared memory; thread d runs one fma chain in position order
  float acc = 0.f;
  for (int s0 = 0; s0 <= p; s0 += V_TILE) {
    const int n = min(V_TILE, p + 1 - s0);
    __syncthreads();  // sc[] written; the previous tile consumed
    for (int i = d; i < n * Dh; i += ATT_THREADS) {
      const int r = i / Dh, j = i - r * Dh, si = s0 + r;
      vt[i] = si == p ? vrow[j]
                      : bf16r(ldf(kv, vbase + (long)si * KVD + j, kv_bf16));
    }
    __syncthreads();
    if (act)
      for (int r = 0; r < n; ++r) acc = fmaf(sc[s0 + r], vt[r * Dh + d], acc);
  }
  if (act) attn[(long)b * QD + hq * Dh + d] = __float2bfloat16_rn(acc);
}

}  // namespace

extern "C" int q3_talker_step(
    const void* x, int x_bf16, const int* pos, const float* cos_t,
    const float* sin_t, const int8_t* qkv_q, const float* qkv_s,
    const int8_t* o_q, const float* o_s, const int8_t* gu_q,
    const float* gu_s, const int8_t* d_q, const float* d_s,
    const void* input_ln, const void* post_ln, const void* q_norm,
    const void* k_norm, int nw_bf16, const void* kv, int kv_bf16,
    void* h_out, float* rows_out, float* hbuf, float* qkv_buf,
    __nv_bfloat16* attn_buf, float* gu_buf, int L, int B, int S, int H,
    int nH, int nKV, int Dh, int I, int eps_bits, int scale_bits,
    void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float eps = host_float(eps_bits);
  const float scale = host_float(scale_bits);
  if (B < 1 || B > QMM_RT || Dh > ATT_THREADS || Dh % 2) return (int)cudaErrorInvalidValue;
  const int QD = nH * Dh, KVD = nKV * Dh, NQKV = QD + 2 * KVD;
  const long esz = nw_bf16 ? 2 : 4, kvsz = kv_bf16 ? 2 : 4;
  const long kv_layer = 2L * B * S * KVD;
  const size_t att_smem = (4 * Dh + 32 + V_TILE * Dh + S) * sizeof(float);
  if (att_smem > 48 * 1024) return (int)cudaErrorInvalidValue;

  // h (f32) = bf16(x): the residual stream starts from the bf16 input
  Q3_TRY(launch_convert(x, x_bf16, hbuf, 0, 1, (long)B * H, st));
  for (int l = 0; l < L; ++l) {
    const char* in_ln = (const char*)input_ln + l * H * esz;
    const char* po_ln = (const char*)post_ln + l * H * esz;
    QmmArgs a = {};
    a.eps = eps; a.R = B;

    // qkv = qmm(bf16(rms(h, input_ln)), qkv)
    a.x = hbuf; a.x_bf16 = 0; a.ldx = H; a.nw = in_ln; a.nw_bf16 = nw_bf16;
    a.w = qkv_q + (long)l * H * NQKV; a.scale = qkv_s + (long)l * NQKV;
    a.out = qkv_buf; a.ldo = NQKV; a.K = H; a.N = NQKV;
    Q3_TRY((launch_qmm<PRO_RMS, int8_t, EPI_STORE_F32>(a, st)));

    talker_attn_kernel<<<dim3(nH, B), ATT_THREADS, att_smem, st>>>(
        qkv_buf, (const char*)q_norm + l * Dh * esz,
        (const char*)k_norm + l * Dh * esz, nw_bf16, cos_t, sin_t, pos,
        (const char*)kv + l * kv_layer * kvsz, kv_bf16, attn_buf,
        rows_out + l * 2L * B * KVD, B, S, nH, nKV, Dh, eps, scale);
    Q3_TRY(cudaGetLastError());

    // h += qmm(attn, o_proj)
    a = QmmArgs{}; a.eps = eps; a.R = B;
    a.x = attn_buf; a.x_bf16 = 1; a.ldx = QD;
    a.w = o_q + (long)l * QD * H; a.scale = o_s + (long)l * H;
    a.out = hbuf; a.ldo = H; a.K = QD; a.N = H;
    Q3_TRY((launch_qmm<PRO_PLAIN, int8_t, EPI_ADD_F32>(a, st)));

    // gu = qmm(bf16(rms(h, post_ln)), gate|up)
    a = QmmArgs{}; a.eps = eps; a.R = B;
    a.x = hbuf; a.x_bf16 = 0; a.ldx = H; a.nw = po_ln; a.nw_bf16 = nw_bf16;
    a.w = gu_q + (long)l * H * 2 * I; a.scale = gu_s + (long)l * 2 * I;
    a.out = gu_buf; a.ldo = 2 * I; a.K = H; a.N = 2 * I;
    Q3_TRY((launch_qmm<PRO_RMS, int8_t, EPI_STORE_F32>(a, st)));

    // h += qmm(bf16(silu(g) * u), down)
    a = QmmArgs{}; a.eps = eps; a.R = B;
    a.x = gu_buf; a.x_bf16 = 0; a.ldx = 2 * I;
    a.w = d_q + (long)l * I * H; a.scale = d_s + (long)l * H;
    a.out = hbuf; a.ldo = H; a.K = I; a.N = H;
    Q3_TRY((launch_qmm<PRO_SWIGLU, int8_t, EPI_ADD_F32>(a, st)));
  }
  // output through bf16, in the input's dtype
  Q3_TRY(launch_convert(hbuf, 0, h_out, x_bf16, 1, (long)B * H, st));
  return 0;
}
