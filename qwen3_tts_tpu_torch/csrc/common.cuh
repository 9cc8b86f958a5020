// Device-side primitives shared by the port's kernels: the cluster-split
// product (qsplit) of qmatmul's decode rows (K1), cp_decode (K2) and
// talker_step (K3, K7), the block reductions of the attention kernels, and
// the cp.async, cluster-barrier and dependent-launch helpers. Twin of
// qwen3_tts_tpu/ops/pallas/common.py:
// one definition of the RMS norm, rotate-half RoPE, the int8 product and
// the masking constant, so the kernels cannot drift apart. Their
// plain PyTorch versions sit in qwen3_tts_tpu_torch/ops/kernels/common.py.
//
// Everything here is in an anonymous namespace: each .cu file gets its
// own copy, and the one shared library links them without clashes.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <atomic>

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
// cp.async, cluster barriers and programmatic dependent launch
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// 4 bytes (one f32) through L1: the .cg form takes 16-byte copies only
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every group of this thread but the newest N has landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Cluster barrier halves. A block arrives (relaxed) as it starts and waits
// before its first store into another block's shared memory, which must
// have started by then; the second arrive (release) and wait (acquire)
// order those stores before the reads that follow.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Programmatic dependent launch. A kernel launched with launch_pdl (or
// launch_qsplit) may start while the previous kernel of the stream still
// runs: before grid_dep_wait() it touches nothing that kernel writes (the
// products only copy their constant weights into shared memory there);
// after it, every write of the previous kernel is visible. grid_dep_launch()
// lets the next kernel start. Without the launch attribute both are no-ops.
__device__ __forceinline__ void grid_dep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void grid_dep_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// launch with the programmatic-serialization attribute and, if cluster >
// 0, clusters of that many blocks along x
template <typename... Params, typename... Args>
cudaError_t launch_pdl(void (*kernel)(Params...), dim3 grid, dim3 block,
                       size_t smem, cudaStream_t st, int cluster,
                       Args&&... args) {
  cudaLaunchAttribute at[2];
  at[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  at[0].val.programmaticStreamSerializationAllowed = 1;
  at[1].id = cudaLaunchAttributeClusterDimension;
  at[1].val.clusterDim.x = cluster;
  at[1].val.clusterDim.y = 1;
  at[1].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = at;
  cfg.numAttrs = cluster > 0 ? 2 : 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Args&&>(args)...);
}

// Lets kernel use up to bytes of dynamic shared memory on the current
// device. The attribute belongs to the device, so it is set once per
// device: done holds one bit per device it was set on (devices past 31
// set it on every call).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, std::atomic<unsigned>& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return e;
}

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
// The summation order of qsplit, the int8 (or bf16 / f32) product of every
// kernel here, and of its plain version ops/kernels/common.qmm. Output
// (r, n) is:
//   c_s = the fmaf chain over k = s, s + 128, s + 256, ... < K, in
//         increasing k, of bf16(x[r, k]) * w[k, n], from 0 (s = 0 .. 127);
//   G_g = (c_{4g} + c_{4g+1}) + (c_{4g+2} + c_{4g+3})   (g = 0 .. 31);
//   acc = (((0 + G_0) + G_1) + ...) + G_31, the groups in order;
//   v   = acc * scale[n] (if any), then + bias[n] (if any).
// A product of a bf16 and an int8 (or of two bf16) is exact in f32, so
// only this order sets the bits. Which thread, warp, block or cluster
// computes a chain or a group changes none of them: a product may map its
// threads freely as long as it keeps the order. (K1's tensor-core tile for
// prefill rows, csrc/qmatmul.cu, sums in the MMA's order and is held to a
// bound instead.)
// ---------------------------------------------------------------------------

constexpr int QMM_KSLICES = 128;                 // k-slices: the chains
constexpr int QMM_GROUPS = QMM_KSLICES / 4;      // groups of 4 slices: 32

// 8 adjacent weights as f32 (f32 weights through bf16)
template <typename W>
__device__ __forceinline__ void load8(const W* w, long i, float v[8]);

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

// prologues: how the bf16 rows xs are made
enum { PRO_PLAIN = 0, PRO_RMS = 1, PRO_SWIGLU = 2, PRO_GATHER = 3 };
// epilogues, on v = acc * scale[n] (+ bias[n])
enum { EPI_STORE_F32 = 0, EPI_ADD_F32 = 1, EPI_STORE_BF16 = 2,
       EPI_ADD_BF16 = 3 };

// ---------------------------------------------------------------------------
// qsplit: the same product for 1 <= R <= 8 rows, its k-slice groups split
// over a thread-block cluster, and up to three weights in one launch.
//
// The columns of every segment (a weight with its scale, bias and output)
// are cut into tiles of QS_NT = 64; a cluster of cs (2, 4 or 8) blocks
// takes one tile, and its rank c the NS = 128 / cs k-slices [c * NS, c *
// NS + NS): the groups [c * 32 / cs, (c + 1) * 32 / cs). A block has
// QS_THREADS = 256 threads in RG = cs / 2 row groups of 4 * NS; thread
// (rg, sl, cl) runs the chains of slice c * NS + sl for the 16 columns
// 16 cl .. 16 cl + 15 of the tile and the rows rg, rg + RG, ... (4 at a
// time), so a warp holds 8 slices of 4 column lanes of one row group, and
// the 4 slices of a group sit in lanes that differ in bits 2 and 3.
//
// A block first copies its weight rows (k = c * NS + sl + 128 j: K / cs rows
// of 64 columns) into shared memory with 16-byte cp.async copies, before
// it waits for the previous kernel (grid_dep_wait): the weights are
// constants, so under programmatic dependent launch their stream overlaps
// the previous kernel; so do the norm weight and each output's scale and
// bias. While they land, it reads its inputs once, 16 bytes a load and
// several loads in flight a thread, into shared memory: the block's k
// values of the rows (RMS: the whole rows), and each output's residual.
// The prologue (plain, RMS-normed, SwiGLU or gathered) works
// from shared memory -- the RMS sum of squares in the lane_dot order of
// common.py, warp r for row r -- and rounds the block's x values to bf16.
// The chains read the weights from shared memory (16 columns in one
// 16-byte load). Warp shuffles add each group; its sums go, through
// distributed shared memory, to the rank that owns their columns (rank c
// the columns [c * 64 / cs, (c + 1) * 64 / cs) of every row), one
// release/acquire cluster barrier later each rank adds its columns' 32
// groups in order and runs the epilogue. One launch, no global scratch.
//
// A segment is chosen by the block's tile: seg[0]'s tiles first, then
// seg[1]'s, ... (q|k|v and gate|up run as one launch each). launch_qsplit
// picks cs from the product's tiles: the fewest blocks a cluster that put
// QS_MIN_BLOCKS = 128 blocks in flight on the 132 SMs, else 8.
// ---------------------------------------------------------------------------

constexpr int QS_NT = 64;                  // columns of a tile
constexpr int QS_CPT = 16;                 // columns of a thread
constexpr int QS_CL = QS_NT / QS_CPT;      // column lanes: 4
constexpr int QS_MAXR = 8;
constexpr int QS_RPT = 4;                  // rows of a thread, at most
constexpr int QS_MAXSEG = 3;
constexpr int QS_THREADS = 256;
constexpr int QS_INFLIGHT = 4;             // 16-byte input loads a thread
constexpr int QS_MAX_SMEM = 200 * 1024;
constexpr int QS_MIN_BLOCKS = 128;

struct QsSeg {
  const void* w; int ldw;       // (K, N) int8 / bf16 / f32, row-major with
                                // a row stride of ldw >= N elements (a
                                // column block of a wider matrix: K7)
  const float* scale;           // (N,) or null
  const void* bias;             // (N,) or null
  void* out; int ldo;           // (R, ldo)
  int N;
};

struct QsArgs {
  const void* x; int x_bf16; int ldx;  // rows (GATHER: the (V, K) table)
  const void* nw; int nw_bf16;         // RMS: norm weight (K,)
  const int* tok;                      // GATHER: table row of each row
  QsSeg seg[QS_MAXSEG]; int nseg;
  int bias_bf16;
  int R, K;
  int cs;                              // blocks a cluster (launch_qsplit)
  float eps;
};

__host__ __device__ inline int qs_tiles(int N) {
  return (N + QS_NT - 1) / QS_NT;
}

inline int qs_cluster_size(int tiles) {
  for (int cs = 2; cs < 8; cs *= 2)
    if (tiles * cs >= QS_MIN_BLOCKS) return cs;
  return 8;
}

// 16 adjacent weights of a staged tile row as f32 (f32 weights through
// bf16, as load8 does)
template <typename W>
__device__ __forceinline__ void load16(const W* w, float v[16]);

template <>
__device__ __forceinline__ void load16<int8_t>(const int8_t* w, float v[16]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(w);
  const uint32_t u[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // byte b + 128 under the exponent of 2^23: 2^23 + 128 + b, exact, less
    // 2^23 + 128 is b
    const uint32_t x = u[i] ^ 0x80808080u;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[4 * i + j] = __fsub_rn(
          __uint_as_float(__byte_perm(x, 0x4b000000u, 0x7540 | j)),
          8388736.f);
  }
}

template <>
__device__ __forceinline__ void load16<__nv_bfloat16>(const __nv_bfloat16* w,
                                                      float v[16]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint4 raw = reinterpret_cast<const uint4*>(w)[h];
    const uint32_t u[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[8 * h + 2 * i] = __uint_as_float(u[i] << 16);
      v[8 * h + 2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
}

template <>
__device__ __forceinline__ void load16<float>(const float* w, float v[16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 f = reinterpret_cast<const float4*>(w)[i];
    v[4 * i] = bf16r(f.x); v[4 * i + 1] = bf16r(f.y);
    v[4 * i + 2] = bf16r(f.z); v[4 * i + 3] = bf16r(f.w);
  }
}

// A block's shared memory, byte offsets: the weight tile | the x values
// (bf16) | the group partials it combines | the staged x rows in their
// own type (RMS: whole rows; else the block's k values, SwiGLU gate then
// up) | (RMS) the norm weight.
struct QsLayout {
  int rows;  // k values (weight rows) of a block
  size_t xs, part, stage, nw, total;
};

__host__ __device__ inline size_t qs_align16(size_t b) {
  return (b + 15) / 16 * 16;
}

__host__ __device__ inline QsLayout qs_layout(int pro, int R, int K, int cs,
                                              int wbytes, int xbytes,
                                              int nwbytes) {
  QsLayout l;
  l.rows = (K + QMM_KSLICES - 1) / QMM_KSLICES * (QMM_KSLICES / cs);
  l.xs = (size_t)l.rows * QS_NT * wbytes;
  l.part = l.xs + qs_align16((size_t)R * l.rows * 2);
  l.stage = l.part + (size_t)QMM_GROUPS * R * (QS_NT / cs) * 4;
  const size_t st = pro == PRO_RMS ? (size_t)R * K * xbytes
                    : (size_t)R * l.rows * xbytes * (pro == PRO_SWIGLU ? 2 : 1);
  l.nw = l.stage + qs_align16(st);
  l.total = l.nw + (pro == PRO_RMS ? qs_align16((size_t)K * nwbytes) : 0);
  return l;
}

template <int PRO, typename W, int EPI>
__global__ void __launch_bounds__(QS_THREADS) qsplit_kernel(QsArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float inv_s[QS_MAXR];
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = a.cs, c = (int)cluster.block_rank();
  const int nsh = 7 - (cs == 2 ? 1 : cs == 4 ? 2 : 3);  // NS = 1 << nsh
  const int NS = 1 << nsh, CPR = QS_NT / cs, RG = cs / 2;
  // the segment of this block's tile: constant indices only, so a.seg
  // stays in the parameter space
  int tile = blockIdx.x / cs;
  QsSeg sg = a.seg[0];
  bool here = false;
#pragma unroll
  for (int i = 0; i + 1 < QS_MAXSEG; ++i) {
    if (!here && i + 1 < a.nseg && tile >= qs_tiles(sg.N)) {
      tile -= qs_tiles(sg.N);
      sg = a.seg[i + 1];
    } else {
      here = true;
    }
  }
  const int n0 = tile * QS_NT, K = a.K, R = a.R, t = threadIdx.x;
  const int xb = a.x_bf16 ? 2 : 4, nb = a.nw_bf16 ? 2 : 4;
  const QsLayout L = qs_layout(PRO, R, K, cs, sizeof(W), xb, nb);
  const int rows = L.rows;
  constexpr int WB = QS_NT * (int)sizeof(W);  // bytes of a tile row
  W* wt = reinterpret_cast<W*>(smem);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + L.xs);
  float* part = reinterpret_cast<float*>(smem + L.part);
  unsigned char* stage = smem + L.stage;
  // row jj of the block's k values is k = c * NS + jj % NS + 128 * (jj / NS)
  auto kof = [&](int jj) {
    return c * NS + (jj & (NS - 1)) + QMM_KSLICES * (jj >> nsh);
  };

  // 1. the constants, before the previous kernel is waited for: the
  // weight tile and (RMS) the norm weight by cp.async; the scale and bias
  // of this thread's output (R * CPR <= QS_THREADS: one a thread) into
  // registers
  {
    constexpr int PPR = WB / 16, CPP = 16 / (int)sizeof(W);
    const W* w = reinterpret_cast<const W*>(sg.w);
    for (int i = t; i < rows * PPR; i += QS_THREADS) {
      const int row = i / PPR, p = i % PPR;
      const int k = kof(row), n = n0 + p * CPP;
      char* dst = reinterpret_cast<char*>(wt) + (size_t)row * WB + 16 * p;
      if (k < K && n < sg.N)
        cp_async16(dst, w + (long)k * sg.ldw + n);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
    if (PRO == PRO_RMS)
      for (int i = t; i < K * nb / 16; i += QS_THREADS)
        cp_async16(smem + L.nw + 16 * i,
                   reinterpret_cast<const char*>(a.nw) + 16 * i);
    cp_async_commit();
  }
  const int orow = t / CPR, on = n0 + c * CPR + t % CPR;
  const bool own = orow < R && on < sg.N;
  float o_scale = 0.f, o_bias = 0.f, o_res = 0.f;
  if (own && sg.scale) o_scale = sg.scale[on];
  if (own && sg.bias) o_bias = ldf(sg.bias, on, a.bias_bf16);
  grid_dep_wait();
  grid_dep_launch();
  cluster_arrive_relaxed();
  // the residual this thread's output adds to (final now; only this
  // thread writes it), through L2
  const long oo = (long)orow * sg.ldo + on;
  if (own && EPI == EPI_ADD_F32)
    o_res = __ldcg(reinterpret_cast<const float*>(sg.out) + oo);
  if (own && EPI == EPI_ADD_BF16)
    o_res = __bfloat162float(
        __ldcg(reinterpret_cast<const __nv_bfloat16*>(sg.out) + oo));

  // 2. the x rows into shared memory as they are: 16-byte loads through
  // L2 (written by the previous kernel), QS_INFLIGHT at a time a thread.
  // Piece i holds epp elements, inside one run of NS >= 16 consecutive k
  // of the block and wholly below K or past it (zeros past K).
  {
    const char* x = reinterpret_cast<const char*>(a.x);
    const int epp = 16 / xb;
    const int PR = (PRO == PRO_RMS ? K : rows) / epp;  // pieces of a row
    const int nst = PRO == PRO_SWIGLU ? 2 : 1;         // gate | up
    const int n = nst * R * PR;
    auto src = [&](int i) -> const void* {
      const int h = i / (R * PR), rem = i - h * R * PR;
      const int r = rem / PR, e = (rem - r * PR) * epp;
      if (PRO == PRO_RMS) return x + ((long)r * a.ldx + e) * xb;
      const int k = kof(e);
      if (k >= K) return nullptr;
      const long row = PRO == PRO_GATHER ? (long)a.tok[r] : (long)r;
      return x + (row * a.ldx + (long)h * K + k) * xb;
    };
    for (int i0 = t; i0 < n; i0 += QS_INFLIGHT * QS_THREADS) {
      uint4 v[QS_INFLIGHT];
#pragma unroll
      for (int q = 0; q < QS_INFLIGHT; ++q) {
        const int i = i0 + q * QS_THREADS;
        const void* p = i < n ? src(i) : nullptr;
        v[q] = p ? __ldcg(reinterpret_cast<const uint4*>(p))
                 : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int q = 0; q < QS_INFLIGHT; ++q) {
        const int i = i0 + q * QS_THREADS;
        if (i < n) reinterpret_cast<uint4*>(stage)[i] = v[q];
      }
    }
  }
  __syncthreads();

  // 3. the block's x values as bf16, xs[r * rows + jj] (0 past K)
  if (PRO == PRO_RMS) {
    // one warp a row: the lane_dot order of ops/kernels/common.rms_rows
    const int warp = t >> 5, lane = t & 31;
    for (int r = warp; r < R; r += QS_THREADS / 32) {
      float ss = 0.f;
#pragma unroll 8
      for (int k = lane; k < K; k += 32) {
        const float v = ldf(stage, (long)r * K + k, a.x_bf16);
        ss = fmaf(v, v, ss);
      }
      ss = warp_sum(ss);
      if (lane == 0) inv_s[r] = rms_scale(ss, K, a.eps);
    }
    __syncthreads();
    for (int jj = t; jj < rows; jj += QS_THREADS) {
      const int k = kof(jj);
      const float w = k < K ? ldf(smem + L.nw, k, a.nw_bf16) : 0.f;
      for (int r = 0; r < R; ++r)
        xs[r * rows + jj] = __float2bfloat16_rn(
            k < K ? rms_apply(ldf(stage, (long)r * K + k, a.x_bf16),
                              inv_s[r], w)
                  : 0.f);
    }
  } else if (PRO == PRO_SWIGLU) {
    // x = gate | up, f32: act = (g * sigmoid(g)) * u (0 past K)
    const float* gs = reinterpret_cast<const float*>(stage);
    const float* us = gs + R * rows;
    for (int i = t; i < R * rows; i += QS_THREADS) {
      const float g = gs[i];
      const float sg_ = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-g)));
      xs[i] = __float2bfloat16_rn(__fmul_rn(__fmul_rn(g, sg_), us[i]));
    }
  } else {  // PLAIN, GATHER (an exact row gather of the embedding table)
    for (int i = t; i < R * rows; i += QS_THREADS)
      xs[i] = __float2bfloat16_rn(ldf(stage, i, a.x_bf16));
  }
  cp_async_wait<0>();
  __syncthreads();

  // 4. the chains of this thread's rows, QS_RPT at a time; group sums to
  // the ranks owning their columns
  const int rg = t >> (nsh + 2), sl = (t >> 2) & (NS - 1), cl = t & 3;
  const int col = cl * QS_CPT, g = (c * NS + sl) >> 2;
  const int J = rows >> nsh;
  const int npass = (R + RG * QS_RPT - 1) / (RG * QS_RPT);
  for (int p = 0; p < npass; ++p) {
    float acc[QS_RPT][QS_CPT];
#pragma unroll
    for (int i = 0; i < QS_RPT; ++i)
#pragma unroll
      for (int q = 0; q < QS_CPT; ++q) acc[i][q] = 0.f;
    const int r0 = rg + p * QS_RPT * RG;  // rows r0, r0 + RG, ...
    if (r0 < R) {
#pragma unroll 2
      for (int j = 0; j < J; ++j) {
        float wv[QS_CPT];
        load16<W>(wt + (size_t)(j * NS + sl) * QS_NT + col, wv);
#pragma unroll
        for (int i = 0; i < QS_RPT; ++i) {
          const int r = r0 + i * RG;
          if (r < R) {
            const float xv = __bfloat162float(xs[r * rows + j * NS + sl]);
#pragma unroll
            for (int q = 0; q < QS_CPT; ++q)
              acc[i][q] = fmaf(xv, wv[q], acc[i][q]);
          }
        }
      }
    }
    if (p == 0) cluster_wait();  // every block of the cluster has started
#pragma unroll
    for (int i = 0; i < QS_RPT; ++i) {
      const int r = r0 + i * RG;
      if (r < R) {
#pragma unroll
        for (int q = 0; q < QS_CPT; ++q) {
          float v = acc[i][q];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          acc[i][q] = v;
        }
        if ((sl & 3) == 0) {
#pragma unroll
          for (int q = 0; q < QS_CPT; q += 4) {
            const int cc = col + q, owner = cc / CPR;
            float* dst = cluster.map_shared_rank(part, owner) +
                         (g * R + r) * CPR + cc % CPR;
            *reinterpret_cast<float4*>(dst) = make_float4(
                acc[i][q], acc[i][q + 1], acc[i][q + 2], acc[i][q + 3]);
          }
        }
      }
    }
  }
  cluster_arrive();
  cluster_wait();

  // 5. this thread's output of the rank's columns: the 32 groups in
  // order, then * scale, + bias, and the store
  if (own) {
    float v = 0.f;
#pragma unroll
    for (int gg = 0; gg < QMM_GROUPS; ++gg)
      v += part[(gg * R + orow) * CPR + t % CPR];
    if (sg.scale) v = __fmul_rn(v, o_scale);
    if (sg.bias) v = __fadd_rn(v, o_bias);
    if (EPI == EPI_STORE_F32)
      reinterpret_cast<float*>(sg.out)[oo] = v;
    else if (EPI == EPI_ADD_F32)
      reinterpret_cast<float*>(sg.out)[oo] = __fadd_rn(o_res, v);
    else if (EPI == EPI_STORE_BF16)
      reinterpret_cast<__nv_bfloat16*>(sg.out)[oo] = __float2bfloat16_rn(v);
    else  // EPI_ADD_BF16: bf16 residual, bf16 addend
      reinterpret_cast<__nv_bfloat16*>(sg.out)[oo] =
          __float2bfloat16_rn(__fadd_rn(o_res, bf16r(v)));
  }
}

template <int PRO, typename W, int EPI>
cudaError_t launch_qsplit(QsArgs a, cudaStream_t st) {
  const int xb = a.x_bf16 ? 2 : 4, nb = a.nw_bf16 ? 2 : 4;
  // 16-byte copies and loads: of the weights (64 / (16 / sizeof(W)) a
  // tile row; every row start keeps that alignment when w does and ldw *
  // sizeof(W) is a multiple of 16), of the x rows and of the norm weight
  const auto al16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  bool ok = a.R >= 1 && a.R <= QS_MAXR &&
            a.K >= 1 && (a.K * xb) % 16 == 0 && (a.ldx * xb) % 16 == 0 &&
            al16(a.x) && (PRO != PRO_SWIGLU || !a.x_bf16) &&
            (PRO != PRO_RMS || (al16(a.nw) && (a.K * nb) % 16 == 0)) &&
            a.nseg >= 1 && a.nseg <= QS_MAXSEG;
  int tiles = 0;
  for (int i = 0; i < a.nseg && ok; ++i) {
    const QsSeg& s = a.seg[i];
    ok = s.N > 0 && s.N % QS_CPT == 0 && s.ldw >= s.N &&
         (s.ldw * sizeof(W)) % 16 == 0 && al16(s.w);
    tiles += qs_tiles(s.N);
  }
  if (!ok) return cudaErrorInvalidValue;
  a.cs = qs_cluster_size(tiles);
  const size_t smem =
      qs_layout(PRO, a.R, a.K, a.cs, sizeof(W), xb, nb).total;
  if (smem > (size_t)QS_MAX_SMEM) return cudaErrorInvalidValue;
  static std::atomic<unsigned> smem_set{0};  // one per instantiation
  const cudaError_t e =
      allow_smem(qsplit_kernel<PRO, W, EPI>, QS_MAX_SMEM, smem_set);
  if (e != cudaSuccess) return e;
  return launch_pdl(qsplit_kernel<PRO, W, EPI>, dim3(tiles * a.cs),
                    dim3(QS_THREADS), smem, st, a.cs, a);
}

// One qsplit product of rows x (R, K) through up to three weights, built
// up by its setters: rows, then (RMS) the norm weight, then each segment.
struct Product {
  QsArgs a;
  Product(int R, int K, float eps) : a() {
    a.R = R; a.K = K; a.eps = eps;
  }
  Product& rows(const void* x, int x_bf16, int ldx) {
    a.x = x; a.x_bf16 = x_bf16; a.ldx = ldx;
    return *this;
  }
  Product& norm(const void* nw, int nw_bf16) {
    a.nw = nw; a.nw_bf16 = nw_bf16;
    return *this;
  }
  // a weight (K, N) of row stride ldw (0: dense, N) into out (R, ldo)
  Product& seg(const void* w, const float* scale, void* out, int ldo, int N,
               int ldw = 0) {
    a.seg[a.nseg++] = QsSeg{w, ldw ? ldw : N, scale, nullptr, out, ldo, N};
    return *this;
  }
};

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
