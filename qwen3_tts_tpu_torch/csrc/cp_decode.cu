// K2: the code predictor's AR steps 1..14 for 1 <= B <= 8 rows, sampling
// included.
//
// Replaces the TPU kernel qwen3_tts_tpu/ops/pallas/cp_decode.py ::
// cp_decode_steps (with topk_keep_mask and sample_tokens).
//
// Each step i: embed the previous token with codec_embs[i] (exact row
// gather) -> bf16 mtp projection + f32 bias -> 5 int8 layers -> final
// RMSNorm -> int8 lm_heads[i+1] -> top-k keep set -> hash-PRNG Gumbel-max
// (greedy: first-index argmax). Precision points differ from K3: the
// residual x is bf16 and the residual adds happen in bf16; the KV cache
// and attention are f32. The sampling reproduces sample_tokens bit for bit
// in its integer part (sortable-uint transform, k-th largest key, murmur-
// style hash).
//
// Bound on an H100: each step streams the int8 layer stack (5 layers x
// 15.7 MB at the 0.6B geometry), one 2.1 MB lm_head and the 2.1 MB bf16
// mtp projection, 83 MB a step and 1.16 GB a call (0.347 ms at 3.35 TB/s);
// at ~2 flops per weight byte that is far below the tensor-core limit, so
// the bytes bound it. The TPU kernel kept the whole stack in on-chip memory
// for all 14 steps; on the H100 the stack plus the heads (110 MB) exceeds
// the 50 MB L2, so each step streams the weights again.
//
// Design. A step is 28 launches: the embed product, 5 a layer (q|k|v,
// attention, o, gate|up, down), the head product and the sampler. Each
// product is one qsplit launch (common.cuh): 64-column tiles, the k-slice
// groups of a tile split over a cluster of 2-8 blocks so that every
// product has >= 128 blocks, 16-byte weight copies issued before the
// previous kernel is waited for (programmatic dependent launch: the weight
// stream of a product overlaps the kernel before it), the input rows read
// once, and the group sums combined in order through distributed shared
// memory; q|k|v and gate|up are one launch each over the three (two)
// weights. Each keeps the summation order of common.cuh, so K2 stays
// bit-equal to its plain version (ops/kernels/cp_decode.cp_decode_plain).
// launch_qsplit picks each product's cluster size from its tiles. The
// attention kernel is one block per (query head, row); the sampler one
// block per row, whose top-k threshold is a radix select (4 rounds of 8
// bits) of the k-th largest sort key. The f32 KV (16 rows) stays in
// device memory. Times and the per-kernel breakdown: PERF.md
// (qwen3_tts_tpu_torch/tools/bench_cp_decode).
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
  grid_dep_wait();    // q|k|v are written
  grid_dep_launch();  // the o product may start its weight copies
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

constexpr int SAMPLE_BINS = 256;  // 8 bits a radix round

// one block per row: top-k threshold, hash-PRNG Gumbel-max, first-index
// argmax (greedy: argmax of the logits). The threshold is the k-th largest
// sort key (what topk_keep_mask's 32-step bitwise search finds: the
// largest T with count(key >= T) >= k), found by a radix select: 4 rounds,
// each a 256-bin histogram of the next 8 bits of the keys that share the
// bits chosen so far, then a suffix scan that picks the bin holding the
// k-th largest and the rank left within it.
__global__ void __launch_bounds__(SAMPLE_THREADS)
cp_sample_kernel(const float* logits, int V, const int* seeds, int step,
                 int top_k, int greedy, float inv_t, int* tok_cur,
                 int* out, int B) {
  __shared__ int hist[SAMPLE_BINS];
  __shared__ int pick[2];  // the chosen bin, the rank left within it
  __shared__ float rv[32];
  __shared__ int ri[32];
  const int b = blockIdx.x, t = threadIdx.x, lane = t & 31;
  grid_dep_wait();    // the head's logits are written
  grid_dep_launch();  // the next step's embed may start its weight copies
  const float* row = logits + (long)b * V;
  // this thread's logits i = t + j * SAMPLE_THREADS, kept in registers
  // with their sort keys
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
    int kk = top_k;  // rank of the wanted key among the candidates
    for (int round = 0; round < 4; ++round) {
      const int shift = 24 - 8 * round;
      // keys whose bits above this round's byte equal thr's are candidates
      const uint32_t hi = round ? 0xFFFFFFFFu << (shift + 8) : 0u;
      for (int i = t; i < SAMPLE_BINS; i += SAMPLE_THREADS) hist[i] = 0;
      __syncthreads();
#pragma unroll
      for (int j = 0; j < SAMPLE_PER; ++j) {
        const int i = t + j * SAMPLE_THREADS;
        const bool cand = i < V && (key[j] & hi) == thr;
        const int d = cand ? (int)((key[j] >> shift) & 255u) : -1;
        // one shared atomic per distinct bin of the warp
        const unsigned same = __match_any_sync(0xffffffffu, d);
        if (cand && lane == __ffs(same) - 1) atomicAdd(&hist[d], __popc(same));
      }
      __syncthreads();
      if (t < 32) {
        // lane l holds bins 8l .. 8l+7; count(digit >= d) from the top
        int h[8], tot = 0;
#pragma unroll
        for (int q = 0; q < 8; ++q) { h[q] = hist[8 * lane + q]; tot += h[q]; }
        int incl = tot;  // keys in the bins of lanes >= l
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int v = __shfl_down_sync(0xffffffffu, incl, o);
          if (lane + o < 32) incl += v;
        }
        // the largest bin d with count(digit >= d) >= kk, and count(digit
        // > d); the counts grow as d falls, so it is in the highest lane
        // that has one
        int run = incl - tot, best = -1, above = 0;
#pragma unroll
        for (int q = 7; q >= 0; --q) {
          if (best < 0 && run + h[q] >= kk) {
            best = 8 * lane + q;
            above = run;
          }
          run += h[q];
        }
        const unsigned has = __ballot_sync(0xffffffffu, best >= 0);
        if (lane == 31 - __clz(has)) { pick[0] = best; pick[1] = kk - above; }
      }
      __syncthreads();
      thr |= (uint32_t)pick[0] << shift;
      kk = pick[1];
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
  if (B < 1 || B > QS_MAXR || Dh > ATT_THREADS || Dh % 2 || n_steps + 2 > S ||
      V > SAMPLE_THREADS * SAMPLE_PER)
    return (int)cudaErrorInvalidValue;
  const int QD = nH * Dh, KVD = nKV * Dh;
  const long esz = nw_bf16 ? 2 : 4, embsz = emb_bf16 ? 2 : 4;
  const long kv_layer = 2L * B * S * KVD;
  const size_t att_smem = (3 * Dh + 32 + S) * sizeof(float);

  Q3_TRY(launch_convert(kv, kv_bf16, kvbuf, 0, 0, L * kv_layer, st));
  for (int i = 0; i < n_steps; ++i) {
    const int p = i + 2;  // the 2-token prefill holds positions 0, 1
    // x = bf16(embs[i][tok] @ mtp_w + mtp_b); step 0 gathers tok0
    Product e(B, H, eps);
    e.rows((const char*)embs + (long)i * V * H * embsz, emb_bf16, H);
    e.a.tok = i ? tok_cur : tok0;
    e.seg(mtp_w, nullptr, xbuf, H, H);
    e.a.seg[0].bias = mtp_b;
    e.a.bias_bf16 = mtp_bf16;
    Q3_TRY(mtp_bf16 ? (launch_qsplit<PRO_GATHER, __nv_bfloat16,
                                     EPI_STORE_BF16>(e.a, st))
                    : (launch_qsplit<PRO_GATHER, float, EPI_STORE_BF16>(
                          e.a, st)));

    for (int l = 0; l < L; ++l) {
      const void* in_ln = (const char*)input_ln + l * H * esz;
      const void* po_ln = (const char*)post_ln + l * H * esz;
      Product qkv(B, H, eps);
      qkv.rows(xbuf, 1, H).norm(in_ln, nw_bf16)
          .seg(q_q + (long)l * H * QD, q_s + (long)l * QD, q_buf, QD, QD)
          .seg(k_q + (long)l * H * KVD, k_s + (long)l * KVD, k_buf, KVD, KVD)
          .seg(v_q + (long)l * H * KVD, v_s + (long)l * KVD, v_buf, KVD, KVD);
      Q3_TRY((launch_qsplit<PRO_RMS, int8_t, EPI_STORE_F32>(qkv.a, st)));

      Q3_TRY(launch_pdl(cp_attn_kernel, dim3(nH, B), dim3(ATT_THREADS),
                        att_smem, st, 0, (const float*)q_buf,
                        (const float*)k_buf, (const float*)v_buf,
                        (const void*)((const char*)q_norm + l * Dh * esz),
                        (const void*)((const char*)k_norm + l * Dh * esz),
                        nw_bf16, cos_t, sin_t, kvbuf + l * kv_layer, p,
                        attn_buf, B, S, nH, nKV, Dh, eps, scale));

      Product o(B, QD, eps);
      o.rows(attn_buf, 1, QD)
          .seg(o_q + (long)l * QD * H, o_s + (long)l * H, xbuf, H, H);
      Q3_TRY((launch_qsplit<PRO_PLAIN, int8_t, EPI_ADD_BF16>(o.a, st)));

      Product gu(B, H, eps);
      gu.rows(xbuf, 1, H).norm(po_ln, nw_bf16)
          .seg(g_q + (long)l * H * I, g_s + (long)l * I, gu_buf, 2 * I, I)
          .seg(u_q + (long)l * H * I, u_s + (long)l * I, gu_buf + I, 2 * I, I);
      Q3_TRY((launch_qsplit<PRO_RMS, int8_t, EPI_STORE_F32>(gu.a, st)));

      Product dn(B, I, eps);
      dn.rows(gu_buf, 0, 2 * I)
          .seg(d_q + (long)l * I * H, d_s + (long)l * H, xbuf, H, H);
      Q3_TRY((launch_qsplit<PRO_SWIGLU, int8_t, EPI_ADD_BF16>(dn.a, st)));
    }
    Product hd(B, H, eps);
    hd.rows(xbuf, 1, H).norm(final_norm, nw_bf16)
        .seg(head_q + (long)(i + 1) * H * V, head_s + (long)(i + 1) * V,
             logits, V, V);
    Q3_TRY((launch_qsplit<PRO_RMS, int8_t, EPI_STORE_F32>(hd.a, st)));

    Q3_TRY(launch_pdl(cp_sample_kernel, dim3(B), dim3(SAMPLE_THREADS), 0, st,
                      0, (const float*)logits, V, seeds, i, top_k, greedy,
                      inv_t, tok_cur, out, B));
  }
  return 0;
}

// One qsplit product alone -- rows x (R, K) bf16 or f32, int8 w (K, N) of
// row stride ldw, clusters sized by N as in a step: out = qmm(x, w, scale)
// (f32); with a norm weight nw, out = qmm(rms(x, nw), w, scale) (PRO_RMS);
// with add, out += qmm(x, w, scale) (EPI_ADD_F32, no norm). The product
// held against its plain version at each width and path of a step.
extern "C" int q3_qsplit(const void* x, int x_bf16, const void* nw,
                         int nw_bf16, const int8_t* w, int ldw,
                         const float* scale, float* out, int add, int R,
                         int K, int N, int eps_bits, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  Product p(R, K, host_float(eps_bits));
  p.rows(x, x_bf16, K).seg(w, scale, out, N, N, ldw);
  if (nw && add) return (int)cudaErrorInvalidValue;
  if (nw)
    return (int)launch_qsplit<PRO_RMS, int8_t, EPI_STORE_F32>(
        p.norm(nw, nw_bf16).a, st);
  if (add)
    return (int)launch_qsplit<PRO_PLAIN, int8_t, EPI_ADD_F32>(p.a, st);
  return (int)launch_qsplit<PRO_PLAIN, int8_t, EPI_STORE_F32>(p.a, st);
}
