// K6: one-token GQA decode attention over a per-row scaled int8 KV cache.
//
// Replaces the TPU kernel qwen3_tts_tpu/ops/pallas/kv_int8.py ::
// decode_attention_kv_int8.
//
// out[b, h*G + g, :] = softmax_s(q[b, h*G + g] . K[b, h, s] * scale, s <=
// pos[b]) . V[b, h], where K[b, h, s, j] = float(kq[b, h, s, j]) * ks[b, h,
// s] (the TPU kernel's dequantize, one f32 product per element) and V
// likewise. q is read as f32 (from bf16 or f32); scores, the
// max-subtracted softmax, p / sum(p) and P.V are f32; the output is stored
// in q's dtype. Keys past pos are skipped: the TPU kernel masks them at
// -1e30, where exp underflows to exactly 0 in f32, so skipping them
// changes no bit.
//
// Bound on an H100: a step reads, for positions 0..pos of each row, the
// int8 K and V rows and their f32 scales once (2 x (pos+1) x Hkv x (Dh +
// 4) bytes; at B = 4, S = 512 at most 4.3 MB, 1.3 us at 3.35 TB/s),
// against ~4 flops per element: bound by HBM bandwidth. The cache is read
// in its kernel-native (B, Hkv, S, Dh) layout, where a head's rows are
// contiguous, and dequantized in registers after the load, so the HBM
// stream is the int8 one. One block per (kv head, row): the G query heads
// of the group share every K and V row it loads. Scores: one warp per
// position, lane j loads one byte at each of j, j + 32, ... (4 single-byte
// loads a lane for Dh = 128, not one 4-byte load), then a warp sum; P.V
// stages KV8_VTILE dequantized V rows in shared
// memory and runs one fma chain per output in position order. The plain
// version (ops/kernels/kv_int8.py) follows both orders. B x Hkv blocks (32
// at B = 4) leave most SMs idle, as in K5: splitting the positions over
// more blocks is later work.
#include "common.cuh"

namespace {

constexpr int KV8_MAXG = 8;    // query heads per kv head
constexpr int KV8_VTILE = 32;  // V rows staged per P.V pass

__global__ void __launch_bounds__(ATT_THREADS)
kv8_attn_kernel(const void* q, int q_bf16, const int8_t* kq, const float* ks,
                const int8_t* vq, const float* vs, const int* pos, void* out,
                int S, int Hq, int Hkv, int Dh, float scale) {
  extern __shared__ float sm[];
  const int G = Hq / Hkv;
  float* qs = sm;                   // G * Dh
  float* red = qs + G * Dh;         // 32
  float* vt = red + 32;             // KV8_VTILE * Dh
  float* sc = vt + KV8_VTILE * Dh;  // G * S
  const int h = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const int p = min(max(pos[b], 0), S - 1);
  const long head = (long)b * Hkv + h;     // [b, h] of (B, Hkv, S, ...)
  const long rbase = head * S * Dh;        // kq / vq [b, h, 0, 0]
  const long sbase = head * S;             // ks / vs [b, h, 0]
  const long qbase = ((long)b * Hq + (long)h * G) * Dh;

  for (int i = t; i < G * Dh; i += ATT_THREADS)
    qs[i] = ldf(q, qbase + i, q_bf16);
  __syncthreads();

  // scores: one warp per position, lanes over Dh, G dots per K row
  const int warp = t >> 5, lane = t & 31, nw = ATT_THREADS / 32;
  for (int si = warp; si <= p; si += nw) {
    float acc[KV8_MAXG];
#pragma unroll
    for (int g = 0; g < KV8_MAXG; ++g) acc[g] = 0.f;
    const int8_t* row = kq + rbase + (long)si * Dh;
    const float rs = ks[sbase + si];
    for (int j = lane; j < Dh; j += 32) {
      const float kj = __fmul_rn((float)row[j], rs);
#pragma unroll
      for (int g = 0; g < KV8_MAXG; ++g)
        if (g < G) acc[g] = fmaf(qs[g * Dh + j], kj, acc[g]);
    }
#pragma unroll
    for (int g = 0; g < KV8_MAXG; ++g) {
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
  // order over V rows dequantized into shared memory KV8_VTILE at a time
  const bool act = t < G * Dh;
  const int g = act ? t / Dh : 0, d = act ? t - g * Dh : 0;
  float acc = 0.f;
  for (int s0 = 0; s0 <= p; s0 += KV8_VTILE) {
    const int n = min(KV8_VTILE, p + 1 - s0);
    __syncthreads();  // scores final; the previous tile consumed
    for (int i = t; i < n * Dh; i += ATT_THREADS) {
      const int r = i / Dh;
      vt[i] = __fmul_rn((float)vq[rbase + (long)s0 * Dh + i],
                        vs[sbase + s0 + r]);
    }
    __syncthreads();
    if (act)
      for (int r = 0; r < n; ++r)
        acc = fmaf(sc[g * S + s0 + r], vt[r * Dh + d], acc);
  }
  if (act) stf(out, qbase + (long)g * Dh + d, q_bf16, acc);
}

}  // namespace

extern "C" int q3_decode_attention_kv_int8(
    const void* q, int q_bf16, const int8_t* kq, const float* ks,
    const int8_t* vq, const float* vs, const int* pos, void* out, int B,
    int S, int Hq, int Hkv, int Dh, int scale_bits, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || Hkv < 1 || Hq % Hkv || Hq / Hkv > KV8_MAXG ||
      (Hq / Hkv) * Dh > ATT_THREADS)
    return (int)cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  const size_t smem =
      (size_t)(G * Dh + 32 + KV8_VTILE * Dh + G * S) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  kv8_attn_kernel<<<dim3(Hkv, B), ATT_THREADS, smem, st>>>(
      q, q_bf16, kq, ks, vq, vs, pos, out, S, Hq, Hkv, Dh,
      host_float(scale_bits));
  return (int)cudaGetLastError();
}
