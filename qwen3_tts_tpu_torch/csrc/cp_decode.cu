// K2: the code predictor's AR steps 1..14 for 1 <= B <= 8 rows, sampling
// included.
//
// Replaces the TPU kernel qwen3_tts_tpu/ops/pallas/cp_decode.py ::
// cp_decode_steps (with topk_keep_mask and sample_tokens).
//
// Each step i: embed the previous token with codec_embs[i] (exact row
// gather) -> bf16 mtp projection + f32 bias -> 5 int8 layers -> final
// RMSNorm -> int8 lm_heads[i+1] -> top-k keep set by a 32-step bitwise
// threshold search -> hash-PRNG Gumbel-max (greedy: first-index argmax).
// Precision points differ from K3: the residual x is bf16 and the
// residual adds happen in bf16; the KV cache and attention are f32.
// The sampling reproduces sample_tokens bit for bit in its integer part
// (sortable-uint transform, threshold search, murmur-style hash).
//
// Bound on an H100: each step streams the int8 layer stack (5 layers x
// 15.7 MB at the 0.6B geometry), one 2.1 MB lm_head and the 2.1 MB bf16
// mtp projection, 83 MB a step and 1.16 GB a token; at ~2 flops per
// weight byte that is far below the tensor-core limit, so the kernel is
// bound by HBM bandwidth. The TPU kernel kept the whole stack in on-chip
// memory for all 14 steps; on the H100 the stack plus the heads (110 MB)
// exceeds the 50 MB L2, so each step streams the weights again.
// The design reads every weight byte once per step in int8 (the qmm tiles
// of common.cuh) and keeps the f32 KV (16 rows) in device memory. A step
// is a fixed sequence of launches (embed, 8 per layer, head, sample).
#include "common.cuh"

namespace {

constexpr int SAMPLE_THREADS = 1024;
constexpr int SAMPLE_PER = 4;  // logits per sampling thread: V <= 4096

// one block per (query head, row); attends over positions 0..p of the f32
// cache (the fresh row substituted) and writes the fresh row at p
__global__ void __launch_bounds__(ATT_THREADS)
cp_attn_kernel(const float* qb, const float* kb, const float* vb,
               const void* qn, const void* kn, int nw_bf16,
               const float* cos_t, const float* sin_t, float* kv, int p,
               __nv_bfloat16* attn, int B, int S, int nH, int nKV, int Dh,
               float eps, float scale) {
  extern __shared__ float sm[];
  float* qrow = sm;
  float* krow = qrow + Dh;
  float* tmp = krow + Dh;
  float* red = tmp + Dh;
  float* sc = red + 32;
  const int hq = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int G = nH / nKV, h = hq / G;
  const int QD = nH * Dh, KVD = nKV * Dh;
  const bool act = d < Dh;
  const float c = act ? cos_t[(long)p * Dh + d] : 0.f;
  const float s = act ? sin_t[(long)p * Dh + d] : 0.f;

  float x = act ? qb[(long)b * QD + hq * Dh + d] : 0.f;
  float inv = rms_scale(block_sum(__fmul_rn(x, x), red), Dh, eps);
  if (act) tmp[d] = rms_apply(x, inv, ldf(qn, d, nw_bf16));
  __syncthreads();
  if (act) qrow[d] = rope_at(tmp, d, Dh, c, s);
  __syncthreads();
  x = act ? kb[(long)b * KVD + h * Dh + d] : 0.f;
  inv = rms_scale(block_sum(__fmul_rn(x, x), red), Dh, eps);
  if (act) tmp[d] = rms_apply(x, inv, ldf(kn, d, nw_bf16));
  __syncthreads();
  const float vnew = act ? vb[(long)b * KVD + h * Dh + d] : 0.f;
  if (act) krow[d] = rope_at(tmp, d, Dh, c, s);
  __syncthreads();

  const long kbase = (long)b * S * KVD + h * Dh;   // K[b, s, h, :]
  const long vbase = (long)B * S * KVD + kbase;    // V[b, s, h, :]
  if (act && hq % G == 0) {
    kv[kbase + (long)p * KVD + d] = krow[d];
    kv[vbase + (long)p * KVD + d] = vnew;
  }
  const int warp = d >> 5, lane = d & 31, nw = ATT_THREADS / 32;
#pragma unroll 4
  for (int si = warp; si <= p; si += nw) {
    float acc = 0.f;
    for (int j = lane; j < Dh; j += 32) {
      const float k_ = si == p ? krow[j] : kv[kbase + (long)si * KVD + j];
      acc = fmaf(qrow[j], k_, acc);
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
  tot = block_sum(tot, red);
  if (act) {
    float acc = 0.f;
#pragma unroll 4
    for (int si = 0; si <= p; ++si) {
      const float v_ = si == p ? vnew : kv[vbase + (long)si * KVD + d];
      acc = fmaf(__fdiv_rn(sc[si], tot), v_, acc);
    }
    attn[(long)b * QD + hq * Dh + d] = __float2bfloat16_rn(acc);
  }
}

__device__ __forceinline__ uint32_t sort_key(float f) {
  const uint32_t bits = __float_as_uint(f);
  return bits ^ ((bits >> 31) ? 0xFFFFFFFFu : 0x80000000u);
}

__device__ int block_count(int v, int* ired) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  v = __reduce_add_sync(0xffffffffu, v);
  __syncthreads();
  if (lane == 0) ired[w] = v;
  __syncthreads();
  int t = 0;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) t += ired[i];
  return t;
}

// one block per row: top-k threshold, hash-PRNG Gumbel-max, first-index
// argmax (greedy: argmax of the logits)
__global__ void __launch_bounds__(SAMPLE_THREADS)
cp_sample_kernel(const float* logits, int V, const int* seeds, int step,
                 int top_k, int greedy, float inv_t, int* tok_cur,
                 int* out, int B) {
  __shared__ int ired[32];
  __shared__ float rv[32];
  __shared__ int ri[32];
  const int b = blockIdx.x, t = threadIdx.x;
  const float* row = logits + (long)b * V;
  // this thread's logits i = t + j * SAMPLE_THREADS, kept in registers
  // with their sort keys (0 past V: no candidate threshold is <= 0)
  float lv[SAMPLE_PER];
  uint32_t key[SAMPLE_PER];
#pragma unroll
  for (int j = 0; j < SAMPLE_PER; ++j) {
    const int i = t + j * SAMPLE_THREADS;
    lv[j] = i < V ? row[i] : 0.f;
    key[j] = i < V ? sort_key(lv[j]) : 0u;
  }
  uint32_t thr = 0;
  if (!greedy) {
    for (int bit = 0; bit < 32; ++bit) {
      const uint32_t cand = thr | (0x80000000u >> bit);
      int cnt = 0;
#pragma unroll
      for (int j = 0; j < SAMPLE_PER; ++j) cnt += key[j] >= cand;
      if (block_count(cnt, ired) >= top_k) thr = cand;
    }
  }
  const uint32_t seed = (uint32_t)seeds[b];
  float best = -INFINITY;
  int best_i = V;
#pragma unroll
  for (int j = 0; j < SAMPLE_PER; ++j) {
    const int i = t + j * SAMPLE_THREADS;
    if (i >= V) break;
    const float l = lv[j];
    float z = l;
    if (!greedy) {
      if (key[j] >= thr) {
        uint32_t h = seed * 2654435761u + (uint32_t)step * 40503u +
                     (uint32_t)i * 2246822519u;
        h ^= h >> 16;
        h *= 2246822519u;
        h ^= h >> 13;
        h *= 3266489917u;
        h ^= h >> 16;
        float u = __fmul_rn((float)(int)(h >> 9), 1.0f / 8388608.0f);
        // f32(1 - 1e-6) and f32(1e-7), as sample_tokens rounds them
        u = __fadd_rn(__fmul_rn(u, __int_as_float(0x3f7fffef)),
                      __int_as_float(0x33d6bf95));
        const float g = -logf(-logf(u));
        z = __fadd_rn(__fmul_rn(l, inv_t), g);
      } else {
        z = Q3_NEG;
      }
    }
    if (z > best) { best = z; best_i = i; }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, best_i, o);
    if (ov > best || (ov == best && oi < best_i)) { best = ov; best_i = oi; }
  }
  if ((t & 31) == 0) { rv[t >> 5] = best; ri[t >> 5] = best_i; }
  __syncthreads();
  if (t == 0) {
    for (int w = 1; w < SAMPLE_THREADS / 32; ++w)
      if (rv[w] > best || (rv[w] == best && ri[w] < best_i)) {
        best = rv[w]; best_i = ri[w];
      }
    tok_cur[b] = best_i;
    out[(long)step * B + b] = best_i;
  }
}

template <typename WD>
cudaError_t embed(QmmArgs a, cudaStream_t st) {
  return launch_qmm<PRO_GATHER, WD, EPI_STORE_BF16>(a, st);
}

}  // namespace

extern "C" int q3_cp_decode(
    const int* tok0, const int* seeds, const float* cos_t,
    const float* sin_t, const int8_t* q_q, const float* q_s,
    const int8_t* k_q, const float* k_s, const int8_t* v_q,
    const float* v_s, const int8_t* o_q, const float* o_s,
    const int8_t* g_q, const float* g_s, const int8_t* u_q,
    const float* u_s, const int8_t* d_q, const float* d_s,
    const void* input_ln, const void* post_ln, const void* q_norm,
    const void* k_norm, const void* final_norm, int nw_bf16,
    const void* mtp_w, const void* mtp_b, int mtp_bf16, const void* embs,
    int emb_bf16, const int8_t* head_q, const float* head_s, const void* kv,
    int kv_bf16, int* out, float* kvbuf, __nv_bfloat16* xbuf, float* q_buf,
    float* k_buf, float* v_buf, __nv_bfloat16* attn_buf, float* gu_buf,
    float* logits, int* tok_cur, int L, int B, int S, int H, int nH,
    int nKV, int Dh, int I, int V, int n_steps, int top_k, int greedy,
    int inv_t_bits, int eps_bits, int scale_bits, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float eps = host_float(eps_bits);
  const float scale = host_float(scale_bits);
  const float inv_t = host_float(inv_t_bits);
  if (B < 1 || B > QMM_RT || Dh > ATT_THREADS || Dh % 2 || n_steps + 2 > S ||
      V > SAMPLE_THREADS * SAMPLE_PER)
    return (int)cudaErrorInvalidValue;
  const int QD = nH * Dh, KVD = nKV * Dh;
  const long esz = nw_bf16 ? 2 : 4, embsz = emb_bf16 ? 2 : 4;
  const long kv_layer = 2L * B * S * KVD;
  const size_t att_smem = (3 * Dh + 32 + S) * sizeof(float);

  Q3_TRY(launch_convert(kv, kv_bf16, kvbuf, 0, 0, L * kv_layer, st));
  Q3_TRY(cudaMemcpyAsync(tok_cur, tok0, B * sizeof(int),
                         cudaMemcpyDeviceToDevice, st));
  for (int i = 0; i < n_steps; ++i) {
    const int p = i + 2;  // the 2-token prefill holds positions 0, 1
    QmmArgs a = {};
    a.eps = eps; a.R = B;
    a.x = (const char*)embs + (long)i * V * H * embsz; a.x_bf16 = emb_bf16;
    a.tok = tok_cur; a.K = H; a.ldx = H;
    a.w = mtp_w; a.bias = mtp_b; a.bias_bf16 = mtp_bf16;
    a.out = xbuf; a.ldo = H; a.N = H; a.ldw = H;
    Q3_TRY(mtp_bf16 ? embed<__nv_bfloat16>(a, st) : embed<float>(a, st));

    for (int l = 0; l < L; ++l) {
      const void* in_ln = (const char*)input_ln + l * H * esz;
      const void* po_ln = (const char*)post_ln + l * H * esz;
      const int8_t* wq[3] = {q_q + (long)l * H * QD, k_q + (long)l * H * KVD,
                             v_q + (long)l * H * KVD};
      const float* ws[3] = {q_s + (long)l * QD, k_s + (long)l * KVD,
                            v_s + (long)l * KVD};
      float* outs[3] = {q_buf, k_buf, v_buf};
      const int ns[3] = {QD, KVD, KVD};
      for (int j = 0; j < 3; ++j) {
        a = QmmArgs{}; a.eps = eps; a.R = B;
        a.x = xbuf; a.x_bf16 = 1; a.ldx = H; a.nw = in_ln;
        a.nw_bf16 = nw_bf16; a.w = wq[j]; a.scale = ws[j];
        a.out = outs[j]; a.ldo = ns[j]; a.K = H; a.N = ns[j]; a.ldw = ns[j];
        Q3_TRY((launch_qmm<PRO_RMS, int8_t, EPI_STORE_F32>(a, st)));
      }
      cp_attn_kernel<<<dim3(nH, B), ATT_THREADS, att_smem, st>>>(
          q_buf, k_buf, v_buf, (const char*)q_norm + l * Dh * esz,
          (const char*)k_norm + l * Dh * esz, nw_bf16, cos_t, sin_t,
          kvbuf + l * kv_layer, p, attn_buf, B, S, nH, nKV, Dh, eps, scale);
      Q3_TRY(cudaGetLastError());

      a = QmmArgs{}; a.eps = eps; a.R = B;
      a.x = attn_buf; a.x_bf16 = 1; a.ldx = QD;
      a.w = o_q + (long)l * QD * H; a.scale = o_s + (long)l * H;
      a.out = xbuf; a.ldo = H; a.K = QD; a.N = H; a.ldw = H;
      Q3_TRY((launch_qmm<PRO_PLAIN, int8_t, EPI_ADD_BF16>(a, st)));

      const int8_t* gw[2] = {g_q + (long)l * H * I, u_q + (long)l * H * I};
      const float* gs[2] = {g_s + (long)l * I, u_s + (long)l * I};
      for (int j = 0; j < 2; ++j) {
        a = QmmArgs{}; a.eps = eps; a.R = B;
        a.x = xbuf; a.x_bf16 = 1; a.ldx = H; a.nw = po_ln;
        a.nw_bf16 = nw_bf16; a.w = gw[j]; a.scale = gs[j];
        a.out = gu_buf + j * I; a.ldo = 2 * I; a.K = H; a.N = I; a.ldw = I;
        Q3_TRY((launch_qmm<PRO_RMS, int8_t, EPI_STORE_F32>(a, st)));
      }
      a = QmmArgs{}; a.eps = eps; a.R = B;
      a.x = gu_buf; a.x_bf16 = 0; a.ldx = 2 * I;
      a.w = d_q + (long)l * I * H; a.scale = d_s + (long)l * H;
      a.out = xbuf; a.ldo = H; a.K = I; a.N = H; a.ldw = H;
      Q3_TRY((launch_qmm<PRO_SWIGLU, int8_t, EPI_ADD_BF16>(a, st)));
    }
    a = QmmArgs{}; a.eps = eps; a.R = B;
    a.x = xbuf; a.x_bf16 = 1; a.ldx = H; a.nw = final_norm;
    a.nw_bf16 = nw_bf16; a.w = head_q + (long)(i + 1) * H * V;
    a.scale = head_s + (long)(i + 1) * V;
    a.out = logits; a.ldo = V; a.K = H; a.N = V; a.ldw = V;
    Q3_TRY((launch_qmm<PRO_RMS, int8_t, EPI_STORE_F32>(a, st)));

    cp_sample_kernel<<<B, SAMPLE_THREADS, 0, st>>>(
        logits, V, seeds, i, top_k, greedy, inv_t, tok_cur, out, B);
    Q3_TRY(cudaGetLastError());
  }
  return 0;
}
