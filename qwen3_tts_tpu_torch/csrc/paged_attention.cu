// K4: one-token GQA decode attention over a block-paged KV pool through a
// per-row page table.
//
// Replaces the TPU kernel qwen3_tts_tpu/ops/pallas/paged_attention.py ::
// paged_decode_attention_pallas.
//
// Row b's logical position s lives at pool[table[b, s / psz], s % psz].
// The block walks the logical pages j = 0, 1, ... in order and keeps the
// online softmax state of the TPU kernel in f32: per query head m, l and
// the accumulator; per page m' = max(m, max s), alpha = exp(m - m'),
// p = exp(s - m'), l = l * alpha + sum(p), acc = acc * alpha + p.V. The
// output is acc / (l > 0 ? l : 1), f32. Rows past pos are masked (-1e30 in
// the TPU kernel, where p is exactly 0), and pages wholly past pos are
// skipped: for them m stays, alpha = 1 and p = 0, so skipping is exact.
// Page ids are trusted as the batcher writes them (0, a reserved page,
// for an unallocated entry).
//
// Bound on an H100: like K5, the K and V rows of positions 0..pos (plus
// the table), once each: bound by HBM bandwidth. One block per (kv head,
// row); the G query heads of the group share each K/V row it loads. Within
// a page, scores are one warp per row, the page's sum is one value per
// thread then a block sum, and P.V one fma chain per output over the
// page's rows; the plain version (ops/kernels/paged_attention.py) follows
// this order.
#include "common.cuh"

namespace {

constexpr int PA_MAXG = 8;    // query heads per kv head
constexpr int PA_VTILE = 32;  // V rows staged per P.V pass

__global__ void __launch_bounds__(ATT_THREADS)
paged_attn_kernel(const void* q, int q_bf16, const void* pool_k,
                  const void* pool_v, int kv_bf16, const int* table,
                  const int* pos, float* out, int MAXP, int psz, int Hq,
                  int Hkv, int Dh, float scale) {
  extern __shared__ float sm[];
  const int G = Hq / Hkv;
  float* qs = sm;                  // G * Dh
  float* red = qs + G * Dh;        // 32
  float* vt = red + 32;            // PA_VTILE * Dh
  float* sc = vt + PA_VTILE * Dh;  // G * psz
  const int h = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const int p = min(max(pos[b], 0), MAXP * psz - 1);
  const long KVD = (long)Hkv * Dh;
  const long qbase = ((long)b * Hq + (long)h * G) * Dh;

  for (int i = t; i < G * Dh; i += ATT_THREADS) qs[i] = ldf(q, qbase + i, q_bf16);

  float m[PA_MAXG], l[PA_MAXG];
#pragma unroll
  for (int g = 0; g < PA_MAXG; ++g) {
    m[g] = Q3_NEG;
    l[g] = 0.f;
  }
  const bool act = t < G * Dh;
  const int go = act ? t / Dh : 0, d = act ? t - go * Dh : 0;
  float acc = 0.f;
  const int warp = t >> 5, lane = t & 31, nw = ATT_THREADS / 32;

  for (int j = 0; j * psz <= p; ++j) {
    const long page = (long)table[(long)b * MAXP + j];
    const long base = page * psz * KVD + (long)h * Dh;  // [page, 0, h, 0]
    const int nr = min(psz, p + 1 - j * psz);            // valid rows
    __syncthreads();  // qs written; the previous page's sc and vt consumed

    // scores of the valid rows: one warp per row, lanes over Dh
    for (int r = warp; r < nr; r += nw) {
      float a[PA_MAXG];
#pragma unroll
      for (int g = 0; g < PA_MAXG; ++g) a[g] = 0.f;
      const long row = base + (long)r * KVD;
      for (int jj = lane; jj < Dh; jj += 32) {
        const float kj = ldf(pool_k, row + jj, kv_bf16);
#pragma unroll
        for (int g = 0; g < PA_MAXG; ++g)
          if (g < G) a[g] = fmaf(qs[g * Dh + jj], kj, a[g]);
      }
#pragma unroll
      for (int g = 0; g < PA_MAXG; ++g) {
        if (g < G) {
          const float s = warp_sum(a[g]);
          if (lane == 0) sc[g * psz + r] = __fmul_rn(s, scale);
        }
      }
    }
    __syncthreads();

    // online softmax update per query head; thread t holds row t's p
    float alpha_mine = 1.f;
#pragma unroll
    for (int g = 0; g < PA_MAXG; ++g) {
      if (g < G) {
        float* sg = sc + g * psz;
        float mx = -INFINITY;
        for (int r = t; r < nr; r += ATT_THREADS) mx = fmaxf(mx, sg[r]);
        mx = block_max(mx, red);
        const float m_new = fmaxf(m[g], mx);
        const float alpha = expf(m[g] - m_new);
        float part = 0.f;
        for (int r = t; r < nr; r += ATT_THREADS) {
          const float e = expf(sg[r] - m_new);
          sg[r] = e;
          part += e;
        }
        const float tot = block_sum(part, red);
        l[g] = __fadd_rn(__fmul_rn(l[g], alpha), tot);
        m[g] = m_new;
        if (g == go) alpha_mine = alpha;
      }
    }

    // this page's P.V: one fma chain per output over the page's rows
    float pvp = 0.f;
    for (int s0 = 0; s0 < nr; s0 += PA_VTILE) {
      const int n = min(PA_VTILE, nr - s0);
      __syncthreads();  // p final; the previous tile consumed
      for (int i = t; i < n * Dh; i += ATT_THREADS) {
        const int r = i / Dh, jj = i - r * Dh;
        vt[i] = ldf(pool_v, base + (long)(s0 + r) * KVD + jj, kv_bf16);
      }
      __syncthreads();
      if (act)
        for (int r = 0; r < n; ++r)
          pvp = fmaf(sc[go * psz + s0 + r], vt[r * Dh + d], pvp);
    }
    acc = __fadd_rn(__fmul_rn(acc, alpha_mine), pvp);
  }

  if (act) {
    float lg = 0.f;
#pragma unroll
    for (int g = 0; g < PA_MAXG; ++g)
      if (g == go) lg = l[g];
    out[qbase + (long)go * Dh + d] = __fdiv_rn(acc, lg > 0.f ? lg : 1.f);
  }
}

}  // namespace

extern "C" int q3_paged_attention(const void* q, int q_bf16,
                                  const void* pool_k, const void* pool_v,
                                  int kv_bf16, const int* table,
                                  const int* pos, float* out, int B, int MAXP,
                                  int psz, int Hq, int Hkv, int Dh,
                                  int scale_bits, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (B < 1 || MAXP < 1 || psz < 1 || psz > ATT_THREADS || Hkv < 1 ||
      Hq % Hkv || Hq / Hkv > PA_MAXG || (Hq / Hkv) * Dh > ATT_THREADS)
    return (int)cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  const size_t smem =
      (size_t)(G * Dh + 32 + PA_VTILE * Dh + G * psz) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  paged_attn_kernel<<<dim3(Hkv, B), ATT_THREADS, smem, st>>>(
      q, q_bf16, pool_k, pool_v, kv_bf16, table, pos, out, MAXP, psz, Hq, Hkv,
      Dh, host_float(scale_bits));
  return (int)cudaGetLastError();
}
