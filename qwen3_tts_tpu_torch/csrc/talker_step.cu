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
//
// K7 is the same step, through the same entry point, over the merged
// weight streams of tools/dev/microbench_talker_merged.py: per layer one
// int8 block [qkv | gate|up] (H, QKVD + 2I) and one [o ; down] (QD + I, H),
// and optionally one f32 block of the eight per-layer vectors. It replaces
// the TPU kernel at tools/dev/microbench_talker_merged.py:307 (merged_step;
// body _build_merged_kernel). The layer loop is K3's: only the weight
// pointers, their row strides (the qmm tile's ldw) and the scale and norm
// pointers differ, so K7 is bit-equal to K3 on the same weights. The
// merged TPU kernel saved DMA issues per layer; here each product still
// streams its own column block, so K7 should cost what K3 costs.
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

// a per-layer vector (scales f32; norm weights f32 or bf16): layer l's
// starts at element l * ls of p
struct LVec {
  const void* p;
  long ls;
};

// a per-layer int8 matrix (K, N) stored in rows of ld >= N elements: layer
// l's starts at element l * ls of q; s holds its per-column f32 scales
struct LMat {
  const int8_t* q;
  long ls;
  int ld;
  LVec s;
};

struct TalkerWeights {
  LMat qkv, o, gu, down;
  LVec input_ln, post_ln, q_norm, k_norm;
  int nw_bf16;  // the four norm weights' type
};

const void* at(const LVec& v, int l, long esz) {
  return (const char*)v.p + (long)l * v.ls * esz;
}

// one product h-rows x layer l of m into out, through launch_qmm
template <int PRO, int EPI>
cudaError_t layer_qmm(const LMat& m, int l, const void* x, int x_bf16,
                      int ldx, const void* nw, int nw_bf16, void* out,
                      int ldo, int R, int K, int N, float eps,
                      cudaStream_t st) {
  QmmArgs a = {};
  a.eps = eps; a.R = R;
  a.x = x; a.x_bf16 = x_bf16; a.ldx = ldx; a.nw = nw; a.nw_bf16 = nw_bf16;
  a.w = m.q + (long)l * m.ls; a.ldw = m.ld;
  a.scale = (const float*)at(m.s, l, 4);
  a.out = out; a.ldo = ldo; a.K = K; a.N = N;
  return launch_qmm<PRO, int8_t, EPI>(a, st);
}

int talker_layers(const TalkerWeights& w, const void* x, int x_bf16,
                  const int* pos, const float* cos_t, const float* sin_t,
                  const void* kv, int kv_bf16, void* h_out, float* rows_out,
                  float* hbuf, float* qkv_buf, __nv_bfloat16* attn_buf,
                  float* gu_buf, int L, int B, int S, int H, int nH, int nKV,
                  int Dh, int I, float eps, float scale, cudaStream_t st) {
  if (B < 1 || B > QMM_RT || Dh > ATT_THREADS || Dh % 2)
    return (int)cudaErrorInvalidValue;
  const int QD = nH * Dh, KVD = nKV * Dh, NQKV = QD + 2 * KVD;
  const long esz = w.nw_bf16 ? 2 : 4, kvsz = kv_bf16 ? 2 : 4;
  const long kv_layer = 2L * B * S * KVD;
  const size_t att_smem = (4 * Dh + 32 + V_TILE * Dh + S) * sizeof(float);
  if (att_smem > 48 * 1024) return (int)cudaErrorInvalidValue;

  // h (f32) = bf16(x): the residual stream starts from the bf16 input
  Q3_TRY(launch_convert(x, x_bf16, hbuf, 0, 1, (long)B * H, st));
  for (int l = 0; l < L; ++l) {
    // qkv = qmm(bf16(rms(h, input_ln)), qkv)
    Q3_TRY((layer_qmm<PRO_RMS, EPI_STORE_F32>(
        w.qkv, l, hbuf, 0, H, at(w.input_ln, l, esz), w.nw_bf16, qkv_buf,
        NQKV, B, H, NQKV, eps, st)));

    talker_attn_kernel<<<dim3(nH, B), ATT_THREADS, att_smem, st>>>(
        qkv_buf, at(w.q_norm, l, esz), at(w.k_norm, l, esz), w.nw_bf16,
        cos_t, sin_t, pos, (const char*)kv + l * kv_layer * kvsz, kv_bf16,
        attn_buf, rows_out + l * 2L * B * KVD, B, S, nH, nKV, Dh, eps, scale);
    Q3_TRY(cudaGetLastError());

    // h += qmm(attn, o_proj)
    Q3_TRY((layer_qmm<PRO_PLAIN, EPI_ADD_F32>(
        w.o, l, attn_buf, 1, QD, nullptr, 0, hbuf, H, B, QD, H, eps, st)));

    // gu = qmm(bf16(rms(h, post_ln)), gate|up)
    Q3_TRY((layer_qmm<PRO_RMS, EPI_STORE_F32>(
        w.gu, l, hbuf, 0, H, at(w.post_ln, l, esz), w.nw_bf16, gu_buf,
        2 * I, B, H, 2 * I, eps, st)));

    // h += qmm(bf16(silu(g) * u), down)
    Q3_TRY((layer_qmm<PRO_SWIGLU, EPI_ADD_F32>(
        w.down, l, gu_buf, 0, 2 * I, nullptr, 0, hbuf, H, B, I, H, eps,
        st)));
  }
  // output through bf16, in the input's dtype
  Q3_TRY(launch_convert(hbuf, 0, h_out, x_bf16, 1, (long)B * H, st));
  return 0;
}

}  // namespace

// K3 and K7. Each int8 matrix arrives as (q, layer stride, row stride ld,
// scales, scales' layer stride) and each norm weight as (pointer, layer
// stride), all in elements: K3 passes its four dense stacks (ld = N), K7
// the column and row blocks of its merged [qkv | gate|up] and [o ; down]
// streams, with the scales and norms from sA / sB and the layer dict or
// all from the one vec block.
extern "C" int q3_talker_step(
    const void* x, int x_bf16, const int* pos, const float* cos_t,
    const float* sin_t, const int8_t* qkv_q, long qkv_ls, int qkv_ld,
    const float* qkv_s, long qkv_sls, const int8_t* o_q, long o_ls,
    int o_ld, const float* o_s, long o_sls, const int8_t* gu_q, long gu_ls,
    int gu_ld, const float* gu_s, long gu_sls, const int8_t* d_q,
    long d_ls, int d_ld, const float* d_s, long d_sls, const void* input_ln,
    long in_ls, const void* post_ln, long po_ls, const void* q_norm,
    long qn_ls, const void* k_norm, long kn_ls, int nw_bf16, const void* kv,
    int kv_bf16, void* h_out, float* rows_out, float* hbuf, float* qkv_buf,
    __nv_bfloat16* attn_buf, float* gu_buf, int L, int B, int S, int H,
    int nH, int nKV, int Dh, int I, int eps_bits, int scale_bits,
    void* stream) {
  TalkerWeights w;
  w.qkv = {qkv_q, qkv_ls, qkv_ld, {qkv_s, qkv_sls}};
  w.o = {o_q, o_ls, o_ld, {o_s, o_sls}};
  w.gu = {gu_q, gu_ls, gu_ld, {gu_s, gu_sls}};
  w.down = {d_q, d_ls, d_ld, {d_s, d_sls}};
  w.input_ln = {input_ln, in_ls};
  w.post_ln = {post_ln, po_ls};
  w.q_norm = {q_norm, qn_ls};
  w.k_norm = {k_norm, kn_ls};
  w.nw_bf16 = nw_bf16;
  return talker_layers(w, x, x_bf16, pos, cos_t, sin_t, kv, kv_bf16, h_out,
                       rows_out, hbuf, qkv_buf, attn_buf, gu_buf, L, B, S, H,
                       nH, nKV, Dh, I, host_float(eps_bits),
                       host_float(scale_bits),
                       reinterpret_cast<cudaStream_t>(stream));
}
