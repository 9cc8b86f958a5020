// K5: one-token GQA decode attention over the dense KV cache.
//
// Replaces the TPU kernel qwen3_tts_tpu/ops/pallas/decode_attention.py ::
// decode_attention_pallas.
//
// out[b, h*G + g, :] = softmax_s(q[b, h*G + g] . K[b, s, h] * scale, s <=
// pos[b]) . V[b, :, h], with q, K and V read as f32 (from bf16 or f32),
// scores, max-subtracted softmax and p / sum(p) in f32, then P.V in f32;
// the output is stored in q's dtype. Keys past pos are skipped: the TPU
// kernel masks them at -1e30, where exp underflows to exactly 0 in f32,
// so skipping them changes no bit.
//
// Bound on an H100: a step reads each row's K and V for positions 0..pos
// once (2 x (pos+1) x Hkv x Dh elements; at B = 4, S = 512, bf16, at most
// 8.4 MB, 2.5 us at 3.35 TB/s), against ~4 flops per element: bound by
// HBM bandwidth. The design reads the cache in its native (B, S, Hkv, Dh)
// layout, without the TPU wrapper's transposed copies, in one block per
// (kv head, row): the G query heads of the group share every K and V row
// it loads. Scores are one warp per position (lanes over Dh, then a warp
// sum); P.V stages V_TILE rows in shared memory and runs one fma chain per
// output in position order, the order the plain version follows
// (ops/kernels/decode_attention.py). B x Hkv blocks (32 at B = 4) leave
// most SMs idle: splitting the positions over more blocks is later work.
#include "common.cuh"

namespace {

constexpr int DA_MAXG = 8;    // query heads per kv head
constexpr int DA_VTILE = 32;  // V rows staged per P.V pass

__global__ void __launch_bounds__(ATT_THREADS)
decode_attn_kernel(const void* q, int q_bf16, const void* k, const void* v,
                   int kv_bf16, const int* pos, void* out, int S, int Hq,
                   int Hkv, int Dh, float scale) {
  extern __shared__ float sm[];
  const int G = Hq / Hkv;
  float* qs = sm;                  // G * Dh
  float* red = qs + G * Dh;        // 32
  float* vt = red + 32;            // DA_VTILE * Dh
  float* sc = vt + DA_VTILE * Dh;  // G * S
  const int h = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const int p = min(max(pos[b], 0), S - 1);
  const long KVD = (long)Hkv * Dh;
  const long base = (long)b * S * KVD + (long)h * Dh;  // [b, 0, h, 0]
  const long qbase = ((long)b * Hq + (long)h * G) * Dh;

  for (int i = t; i < G * Dh; i += ATT_THREADS) qs[i] = ldf(q, qbase + i, q_bf16);
  __syncthreads();

  // scores: one warp per position, lanes over Dh, G dots per K row
  const int warp = t >> 5, lane = t & 31, nw = ATT_THREADS / 32;
  for (int si = warp; si <= p; si += nw) {
    float acc[DA_MAXG];
#pragma unroll
    for (int g = 0; g < DA_MAXG; ++g) acc[g] = 0.f;
    const long row = base + (long)si * KVD;
    for (int j = lane; j < Dh; j += 32) {
      const float kj = ldf(k, row + j, kv_bf16);
#pragma unroll
      for (int g = 0; g < DA_MAXG; ++g)
        if (g < G) acc[g] = fmaf(qs[g * Dh + j], kj, acc[g]);
    }
#pragma unroll
    for (int g = 0; g < DA_MAXG; ++g) {
      if (g < G) {
        const float s = warp_sum(acc[g]);
        if (lane == 0) sc[g * S + si] = __fmul_rn(s, scale);
      }
    }
  }
  __syncthreads();

  // softmax per query head: max, exp(s - max), sum in thread order, p/sum
  for (int g = 0; g < G; ++g) {
    float* sg = sc + g * S;
    float m = -INFINITY;
    for (int si = t; si <= p; si += ATT_THREADS) m = fmaxf(m, sg[si]);
    m = block_max(m, red);
    float tot = 0.f;
    for (int si = t; si <= p; si += ATT_THREADS) {
      const float e = expf(sg[si] - m);
      sg[si] = e;
      tot += e;
    }
    tot = block_sum(tot, red);
    for (int si = t; si <= p; si += ATT_THREADS) sg[si] = __fdiv_rn(sg[si], tot);
  }

  // P.V: thread t < G * Dh owns output (g, d); one fma chain in position
  // order over V rows staged DA_VTILE at a time
  const bool act = t < G * Dh;
  const int g = act ? t / Dh : 0, d = act ? t - g * Dh : 0;
  float acc = 0.f;
  for (int s0 = 0; s0 <= p; s0 += DA_VTILE) {
    const int n = min(DA_VTILE, p + 1 - s0);
    __syncthreads();  // scores final; the previous tile consumed
    for (int i = t; i < n * Dh; i += ATT_THREADS) {
      const int r = i / Dh, j = i - r * Dh;
      vt[i] = ldf(v, base + (long)(s0 + r) * KVD + j, kv_bf16);
    }
    __syncthreads();
    if (act)
      for (int r = 0; r < n; ++r)
        acc = fmaf(sc[g * S + s0 + r], vt[r * Dh + d], acc);
  }
  if (act) stf(out, qbase + (long)g * Dh + d, q_bf16, acc);
}

}  // namespace

extern "C" int q3_decode_attention(const void* q, int q_bf16, const void* k,
                                   const void* v, int kv_bf16, const int* pos,
                                   void* out, int B, int S, int Hq, int Hkv,
                                   int Dh, int scale_bits, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || Hkv < 1 || Hq % Hkv || Hq / Hkv > DA_MAXG ||
      (Hq / Hkv) * Dh > ATT_THREADS)
    return (int)cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  const size_t smem = (size_t)(G * Dh + 32 + DA_VTILE * Dh + G * S) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  decode_attn_kernel<<<dim3(Hkv, B), ATT_THREADS, smem, st>>>(
      q, q_bf16, k, v, kv_bf16, pos, out, S, Hq, Hkv, Dh, host_float(scale_bits));
  return (int)cudaGetLastError();
}
