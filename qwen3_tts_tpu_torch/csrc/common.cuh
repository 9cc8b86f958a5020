// Device-side primitives shared by the port's kernels: the qmm tile of
// qmatmul (K1), cp_decode (K2) and talker_step (K3, K7), and the block
// reductions of the attention kernels. Twin of
// qwen3_tts_tpu/ops/pallas/common.py:
// one definition of the RMS norm, rotate-half RoPE, the int8 product and
// the masking constant, so the three kernels cannot drift apart. Their
// plain PyTorch versions sit in qwen3_tts_tpu_torch/ops/kernels/common.py.
//
// Everything here is in an anonymous namespace: each .cu file gets its
// own copy, and the one shared library links them without clashes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#define Q3_NEG (-1e30f)

namespace {

// ---------------------------------------------------------------------------
// scalar helpers
// ---------------------------------------------------------------------------

// a float passed across ctypes as its f32 bit pattern (host side)
inline float host_float(int bits) {
  float f;
  memcpy(&f, &bits, sizeof f);
  return f;
}

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// element i of a float tensor stored as f32 (is_bf16 == 0) or bf16
__device__ __forceinline__ float ldf(const void* p, long i, int is_bf16) {
  return is_bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i])
                 : reinterpret_cast<const float*>(p)[i];
}

__device__ __forceinline__ void stf(void* p, long i, int is_bf16, float v) {
  if (is_bf16)
    reinterpret_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else
    reinterpret_cast<float*>(p)[i] = v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide sum / max; every thread of the block must call it, and every
// thread gets the result. red: shared scratch of >= 32 floats. The final
// sum runs over the warps in a fixed order, so results are reproducible.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) red[w] = v;
  __syncthreads();
  float t = 0.f;
  for (int i = 0; i < nw; ++i) t += red[i];
  return t;
}

__device__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) red[w] = v;
  __syncthreads();
  float t = red[0];
  for (int i = 1; i < nw; ++i) t = fmaxf(t, red[i]);
  return t;
}

// threads of an attention block (one block per query head and row); the
// plain versions' ATT_THREADS (ops/kernels/common.py) must equal it, since
// the block-wide sums run over this many threads
constexpr int ATT_THREADS = 512;

// ---------------------------------------------------------------------------
// K0 rms: RMSNorm entirely in f32 -- x * rsqrt(mean(x*x) + eps) * w. NOT the
// HF cast order of models/transformer.rms_norm (common.py:16-28).
// ---------------------------------------------------------------------------

// 1 / sqrt(sumsq / D + eps), every step correctly rounded (the plain
// versions compute the same bits)
__device__ __forceinline__ float rms_scale(float sumsq, int D, float eps) {
  return __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(__fdiv_rn(sumsq, (float)D), eps)));
}

__device__ __forceinline__ float rms_apply(float x, float inv, float w) {
  return __fmul_rn(__fmul_rn(x, inv), w);
}

// K0 rot_mat: rotate_half (HF) on a head row in shared memory:
// out[d] = x[d] * cos + rotate_half(x)[d] * sin, rotate_half(x) =
// concat(-x[half:], x[:half]).
__device__ __forceinline__ float rope_at(const float* row, int d, int Dh,
                                         float c, float s) {
  const int half = Dh >> 1;
  const float r = d < half ? -row[d + half] : row[d - half];
  return __fadd_rn(__fmul_rn(row[d], c), __fmul_rn(r, s));
}

// ---------------------------------------------------------------------------
// K0 qmm: out[r, n] = (sum_k bf16(x[r, k]) * bf16(w[k, n])) * scale[n]
//
// w is row-major with a row stride of ldw >= N elements: a product may read
// a column block of a wider matrix (the merged weight streams of K7).
// One block computes a tile of up to QMM_RT rows x QMM_NT = 32 adjacent
// columns. The rows sit in shared memory as bf16 (xs, row stride K); the
// prologue that fills them (plain, RMS-normed, SwiGLU or gathered) is the
// caller's. The sum over k is cut into QMM_KSLICES = 128 k-slices: slice
// ks runs one fma chain over k = ks, ks + 128, ... for each output. 512
// threads: in a warp, lane l owns columns 8*(l%4) .. +7 (one 8-byte int8
// load, so the 4 lanes of a k-row read one 32-byte sector of the
// row-major weight) and slice 8*warp + l/4. Slices 4g .. 4g+3 are added
// pairwise ((s0 + s1) + (s2 + s3)) by warp shuffles, and the 32 group sums
// in order g = 0, 1, ... Products of a bf16 and an int8 (or two bf16) are
// exact in f32, so only this summation order differs from other
// implementations; the plain version (ops/kernels/common.qmm) follows it.
// Every thread keeps up to 8 iterations (64 bytes) of weight loads in
// flight: all of a (1024, 2048) weight, 2 MB, at once.
// ---------------------------------------------------------------------------

constexpr int QMM_RT = 8;                        // rows per tile
constexpr int QMM_NT = 32;                       // columns per tile
constexpr int QMM_CPT = 8;                       // columns per thread
constexpr int QMM_CG = QMM_NT / QMM_CPT;         // column groups: 4
constexpr int QMM_THREADS = 512;
constexpr int QMM_KSLICES = QMM_THREADS / QMM_CG;  // 128
constexpr int QMM_GROUPS = QMM_KSLICES / 4;        // 32
constexpr int QMM_MAX_SMEM = 99 * 1024;

template <typename W>
__device__ __forceinline__ void load8(const W* w, long i, float v[8]);

template <>
__device__ __forceinline__ void load8<int8_t>(const int8_t* w, long i,
                                              float v[8]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(w + i);
  // byte j of a word (little endian: byte 0 is the lowest), sign-extended
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[j] = (float)((int)(raw.x << (24 - 8 * j)) >> 24);
    v[4 + j] = (float)((int)(raw.y << (24 - 8 * j)) >> 24);
  }
}

template <>
__device__ __forceinline__ void load8<__nv_bfloat16>(const __nv_bfloat16* w,
                                                     long i, float v[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(w + i);
  const uint32_t u[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    __nv_bfloat162 b;
    memcpy(&b, &u[j], sizeof b);
    const float2 f = __bfloat1622float2(b);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

template <>
__device__ __forceinline__ void load8<float>(const float* w, long i,
                                             float v[8]) {
  const float4 a = *reinterpret_cast<const float4*>(w + i);
  const float4 b = *reinterpret_cast<const float4*>(w + i + 4);
  v[0] = bf16r(a.x); v[1] = bf16r(a.y); v[2] = bf16r(a.z); v[3] = bf16r(a.w);
  v[4] = bf16r(b.x); v[5] = bf16r(b.y); v[6] = bf16r(b.z); v[7] = bf16r(b.w);
}

// Accumulate the tile; on return thread t < R*32 holds, in *acc_out, the
// unscaled sum of output (t / 32, n0 + t % 32). red: QMM_GROUPS * QMM_RT *
// QMM_NT floats.
template <typename W>
__device__ void qmm_tile(const __nv_bfloat16* xs, int R, int K, const W* w,
                         int N, int ldw, int n0, float* red, float* acc_out) {
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int cg = lane & (QMM_CG - 1), ksl = lane >> 2;
  const int ks = 8 * warp + ksl;
  const int n = n0 + QMM_CPT * cg;
  float acc[QMM_RT][QMM_CPT];
#pragma unroll
  for (int r = 0; r < QMM_RT; ++r)
#pragma unroll
    for (int j = 0; j < QMM_CPT; ++j) acc[r][j] = 0.f;
  if (n < N) {
    // unrolled so that several weight loads are in flight per thread; each
    // output's fma chain still runs in k order
#pragma unroll 8
    for (int k = ks; k < K; k += QMM_KSLICES) {
      float wv[QMM_CPT];
      load8<W>(w, (long)k * ldw + n, wv);
#pragma unroll
      for (int r = 0; r < QMM_RT; ++r) {
        if (r < R) {
          const float xv = __bfloat162float(xs[r * K + k]);
#pragma unroll
          for (int j = 0; j < QMM_CPT; ++j)
            acc[r][j] = fmaf(xv, wv[j], acc[r][j]);
        }
      }
    }
  }
  // slices 4g .. 4g+3 sit in lanes that differ in bits 2 and 3
#pragma unroll
  for (int r = 0; r < QMM_RT; ++r)
#pragma unroll
    for (int j = 0; j < QMM_CPT; ++j) {
      float v = acc[r][j];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      acc[r][j] = v;
    }
  if ((ksl & 3) == 0) {
    const int g = 2 * warp + (ksl >> 2);
#pragma unroll
    for (int r = 0; r < QMM_RT; ++r)
#pragma unroll
      for (int j = 0; j < QMM_CPT; ++j)
        red[(g * QMM_RT + r) * QMM_NT + QMM_CPT * cg + j] = acc[r][j];
  }
  __syncthreads();
  if (t < R * QMM_NT) {
    const int r = t / QMM_NT, col = t % QMM_NT;
    float s = 0.f;
    for (int g = 0; g < QMM_GROUPS; ++g)
      s += red[(g * QMM_RT + r) * QMM_NT + col];
    *acc_out = s;
  }
}

// prologues: how the bf16 rows xs are made
enum { PRO_PLAIN = 0, PRO_RMS = 1, PRO_SWIGLU = 2, PRO_GATHER = 3 };
// epilogues, on v = acc * scale[n] (+ bias[n])
enum { EPI_STORE_F32 = 0, EPI_ADD_F32 = 1, EPI_STORE_BF16 = 2,
       EPI_ADD_BF16 = 3 };

struct QmmArgs {
  const void* x;  int x_bf16; int ldx;  // rows (GATHER: the (V, K) table)
  const void* nw; int nw_bf16;          // RMS: norm weight (K,)
  const int* tok;                       // GATHER: table row of each row
  const void* w; int ldw;               // (K, N) int8 / bf16 / f32, row
                                        // stride ldw (= N when dense)
  const float* scale;                   // (N,) or null
  const void* bias; int bias_bf16;      // (N,) or null
  void* out; int ldo;                   // (R, ldo)
  int R, K, N;
  float eps;
};

template <int PRO, typename W, int EPI>
__global__ void __launch_bounds__(QMM_THREADS) qmm_kernel(QmmArgs a) {
  extern __shared__ float4 smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* red = reinterpret_cast<float*>(xs + QMM_RT * a.K);
  const int r0 = blockIdx.y * QMM_RT;
  const int R = min(QMM_RT, a.R - r0);
  const int K = a.K;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;

  if (PRO == PRO_RMS) {
    // one warp per row (<= 8 rows): f32 RMS, then bf16
    if (warp < R) {
      const long base = (long)(r0 + warp) * a.ldx;
      float ss = 0.f;
#pragma unroll 8
      for (int k = lane; k < K; k += 32) {
        const float v = ldf(a.x, base + k, a.x_bf16);
        ss = fmaf(v, v, ss);
      }
      const float inv = rms_scale(warp_sum(ss), K, a.eps);
#pragma unroll 8
      for (int k = lane; k < K; k += 32)
        xs[warp * K + k] = __float2bfloat16_rn(
            rms_apply(ldf(a.x, base + k, a.x_bf16), inv,
                      ldf(a.nw, k, a.nw_bf16)));
    }
  } else {
#pragma unroll 4
    for (int i = t; i < R * K; i += QMM_THREADS) {
      const int r = i / K, k = i % K;
      float v;
      if (PRO == PRO_PLAIN) {
        v = ldf(a.x, (long)(r0 + r) * a.ldx + k, a.x_bf16);
      } else if (PRO == PRO_SWIGLU) {
        // x = gate | up, f32: act = (g * sigmoid(g)) * u
        const float* gu = reinterpret_cast<const float*>(a.x);
        const long base = (long)(r0 + r) * a.ldx;
        const float g = gu[base + k], u = gu[base + K + k];
        const float sg = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-g)));
        v = __fmul_rn(__fmul_rn(g, sg), u);
      } else {  // PRO_GATHER: exact row gather of the embedding table
        v = ldf(a.x, (long)a.tok[r0 + r] * K + k, a.x_bf16);
      }
      xs[r * K + k] = __float2bfloat16_rn(v);
    }
  }
  __syncthreads();

  const int n0 = blockIdx.x * QMM_NT;
  float acc = 0.f;
  qmm_tile<W>(xs, R, K, reinterpret_cast<const W*>(a.w), a.N, a.ldw, n0, red,
              &acc);
  if (t < R * QMM_NT) {
    const int r = t / QMM_NT, n = n0 + t % QMM_NT;
    if (n < a.N) {
      float v = acc;
      if (a.scale) v = __fmul_rn(v, a.scale[n]);
      if (a.bias) v = __fadd_rn(v, ldf(a.bias, n, a.bias_bf16));
      const long o = (long)(r0 + r) * a.ldo + n;
      if (EPI == EPI_STORE_F32) {
        reinterpret_cast<float*>(a.out)[o] = v;
      } else if (EPI == EPI_ADD_F32) {
        float* out = reinterpret_cast<float*>(a.out);
        out[o] = __fadd_rn(out[o], v);
      } else if (EPI == EPI_STORE_BF16) {
        reinterpret_cast<__nv_bfloat16*>(a.out)[o] = __float2bfloat16_rn(v);
      } else {  // EPI_ADD_BF16: bf16 residual, bf16 addend
        __nv_bfloat16* out = reinterpret_cast<__nv_bfloat16*>(a.out);
        out[o] = __float2bfloat16_rn(
            __fadd_rn(__bfloat162float(out[o]), bf16r(v)));
      }
    }
  }
}

template <int PRO, typename W, int EPI>
cudaError_t launch_qmm(const QmmArgs& a, cudaStream_t st) {
  const size_t smem = (size_t)QMM_RT * a.K * sizeof(__nv_bfloat16) +
                      (size_t)QMM_GROUPS * QMM_RT * QMM_NT * sizeof(float);
  // load8 reads QMM_CPT adjacent weights at once (8 bytes of int8, 16 of
  // bf16, two 16-byte halves of f32): every row start must keep that
  // alignment, so ldw is a multiple of QMM_CPT and w is aligned
  const uintptr_t align = sizeof(W) == 1 ? 8 : 16;
  if (smem > (size_t)QMM_MAX_SMEM || a.N % QMM_CPT != 0 || a.R < 1 ||
      a.ldw < a.N || a.ldw % QMM_CPT != 0 ||
      reinterpret_cast<uintptr_t>(a.w) % align != 0)
    return cudaErrorInvalidValue;
  static bool attr_set = false;  // one per instantiation
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        qmm_kernel<PRO, W, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        QMM_MAX_SMEM);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid((a.N + QMM_NT - 1) / QMM_NT, (a.R + QMM_RT - 1) / QMM_RT);
  qmm_kernel<PRO, W, EPI><<<grid, QMM_THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

// dst[i] = float(src[i]) (src f32 or bf16), optionally through bf16
__global__ void convert_kernel(const void* src, int src_bf16, void* dst,
                               int dst_bf16, int round_bf16, long n) {
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x) {
    float v = ldf(src, i, src_bf16);
    if (round_bf16) v = bf16r(v);
    stf(dst, i, dst_bf16, v);
  }
}

inline cudaError_t launch_convert(const void* src, int src_bf16, void* dst,
                                  int dst_bf16, int round_bf16, long n,
                                  cudaStream_t st) {
  const long want = (n + 255) / 256;
  const int blocks = (int)(want < 4096 ? (want > 0 ? want : 1) : 4096);
  convert_kernel<<<blocks, 256, 0, st>>>(src, src_bf16, dst, dst_bf16,
                                         round_bf16, n);
  return cudaGetLastError();
}

}  // namespace

#define Q3_TRY(expr)                    \
  do {                                  \
    cudaError_t _e = (expr);            \
    if (_e != cudaSuccess) return (int)_e; \
  } while (0)
