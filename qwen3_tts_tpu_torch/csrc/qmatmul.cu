// K1: weight-only int8 matmul, out (M, N) f32 = bf16(x) (M, K) @ bf16(q)
// (K, N) int8, f32 accumulate, x per-column f32 scale.
//
// Replaces the TPU kernel qwen3_tts_tpu/ops/pallas/qmatmul.py ::
// qmatmul_pallas (an MXU dot of bf16(x) and bf16(q) with f32
// accumulation, times the per-column scale). Two routes, chosen by shape
// in ops/kernels/qmatmul.py:
// - decode rows (1 <= M <= 8, K <= 3072, every N a multiple of 16):
//   q3_qmatmul_split, the cluster-split qsplit product of K2 and K3
//   (common.cuh): 64-column tiles, the k-slices of a tile split over a
//   cluster of 2-8 blocks sized so that >= 128 blocks are in flight, each
//   block's weight rows copied into shared memory by 16-byte cp.async
//   before it waits for the previous kernel (programmatic dependent
//   launch), and up to three weights that share x (q|k|v, gate|up) in one
//   launch. It adds up in qsplit's order, bit-equal to its plain version
//   ops/kernels/common.qmm. At M <= 8 a product does at most 16 flops a
//   weight byte, far below the ~295 a byte where the tensor cores would be
//   the limit: it is bound by streaming the weight from HBM (3.35 TB/s).
// - every other shape (prefill rows; N % 8 == 0, K % 16 == 0):
//   q3_qmatmul_tile, the tensor-core tile below.
//
// The tile. At the talker prefill's R = 41 .. 265 rows a product does
// 82 .. 530 flops a weight byte: R = 265 is near the line where the bf16
// tensor cores (989 TFLOP/s) and HBM (3.35 TB/s) bound alike, so the
// products run on the tensor cores, and every weight byte is read once a
// 64-row tile (R <= 64: once).
// - A block of CG x 2 warps computes a 64-row tile of 32 CG columns: warp
//   w owns 32 columns (4 m16 tiles, those past the last row skipped, x 4 n8
//   tiles of mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32) over its
//   k-group's 32 k of every stage.
// - K runs through a ring of TC_STAGES stages of 64 k, filled by cp.async
//   (16 bytes; 8 where N is not a multiple of 16), zero-filled past K, N
//   and the last row: the int8 weight slab (64 x 32 CG bytes) and the x
//   slab (64 rows x 64 k, bf16 or f32) as they are in memory.
// - x fragments: ldmatrix.x4 (bf16 rows), or two f32 loads and one bf16x2
//   rounding a register (f32 rows). Weight fragments: one
//   ldmatrix.x4.trans of the int8 slab read as 16-bit pairs gives a thread
//   the bytes of columns 2c and 2c + 1 at k rows 2t and 2t + 1; bytes 0, 2
//   make the bf16x2 fragment of an n8 tile of the even columns, bytes 1, 3
//   that of the odd ones (int8 -> f32 through the exponent of 2^23, exact,
//   then the upper 16 bits: a bf16 holds any int8 exactly). So each weight
//   byte is converted once a block, in registers, and the bf16 weight
//   never exists in memory. The even/odd split is undone in the epilogue:
//   a thread's two n8 tiles hold 4 adjacent columns of a row.
// - Where the tiles are too few to fill the 132 SMs (< 128 blocks), K is
//   split over a cluster of cs = 2, 4 or 8 blocks (rank c takes the 64-k
//   slabs [c S / cs, (c + 1) S / cs)). Each warp stores its f32 partials,
//   through distributed shared memory, into a slot of the rank that owns
//   their columns; after a release/acquire cluster barrier each rank adds
//   its columns' 2 cs slots in order (rank 0's k-groups, rank 1's, ...),
//   times scale[n], and stores them. No atomics: the same inputs give the
//   same bits on every launch.
// - Two widths: 64 columns in 4 warps (2 x 2), or 128 in 8 (4 x 2) where
//   that needs a K split of exactly 2 (tc_wide). Measured on an H100 a
//   block takes ~0.6-0.8 us a stage whatever its ring depth, width or
//   bytes, and larger clusters cost more; the wide tile gains only where
//   it halves a block's stages without a larger cluster (PERF.md).
// Numbers: the order inside an MMA is the hardware's, so the tile is not
// bit-equal to qmm. It is held to a bound instead: output (r, n) within
// 2^-16 of scale[n] * sum_k |bf16(x[r, k]) q[k, n]| of the product summed
// in float64 (ops/kernels/qmatmul.qmatmul_error).
#include "common.cuh"

namespace {

constexpr int TC_BM = 64;             // rows of a block tile
constexpr int TC_BK = 64;             // k of a ring stage
constexpr int TC_STAGES = 4;
constexpr int TC_XS = TC_BK + 8;      // elements of a staged x row
constexpr int TC_MIN_BLOCKS = 128;
constexpr int TC_KG = 2;              // k-groups: warps that split a stage

// A tile of CG column groups x TC_KG k-groups of warps: warp w computes
// columns 32 (w % CG) .. + 31 of all TC_BM rows over the k-group w / CG's
// share of each stage. The row pads (16 bytes of a weight row, 8 elements
// of an x row) keep every ldmatrix and fragment load free of bank
// conflicts.
template <int CG>
struct Tc {
  static constexpr int BN = 32 * CG, THREADS = 32 * CG * TC_KG;
  static constexpr int KW = TC_BK / TC_KG;  // k of a warp's share a stage
  static_assert(KW % 32 == 0, "a k-group takes whole 32-k steps");
  static constexpr int WS = BN + 16;  // bytes of a staged weight row
  // bytes of the x slab (TC_BM rows of TC_XS elements) and of a ring
  // stage (then the weight slab, TC_BK rows of WS bytes)
  template <bool XBF>
  __host__ __device__ static constexpr int xbytes() {
    return TC_BM * TC_XS * (XBF ? 2 : 4);
  }
  template <bool XBF>
  __host__ __device__ static constexpr int stage() {
    return xbytes<XBF>() + TC_BK * WS;
  }
};

struct TcArgs {
  const void* x;          // (M, K) bf16 or f32, rows dense
  const int8_t* w;        // (K, N), rows dense
  const float* scale;     // (N,)
  float* out;             // (M, N)
  int M, K, N;
  int cs;                 // blocks a cluster: the K split
  int w16;                // weight rows copied 16 bytes at a time (else 8)
};

// cp.async of cp bytes, of which the first src bytes are read and the rest
// zero-filled (src = 0 reads nothing)
__device__ __forceinline__ void cp_async16_zf(void* dst, const void* src,
                                              int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async8_zf(void* dst, const void* src,
                                             int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

// c += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The four int8 bytes of r as bf16: e = {byte 0, byte 2}, o = {byte 1,
// byte 3}, the first in the low half. Byte b + 128 under the exponent of
// 2^23 is 2^23 + 128 + b, exact; less 2^23 + 128 it is b, whose f32 bits
// have zeros in their low 16, so the high 16 are bf16(b) exactly.
__device__ __forceinline__ void i8x4_bf16(uint32_t r, uint32_t& e,
                                          uint32_t& o) {
  const uint32_t x = r ^ 0x80808080u;
  uint32_t f[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __float_as_uint(__fsub_rn(
        __uint_as_float(__byte_perm(x, 0x4b000000u, 0x7540 | j)),
        8388736.f));
  e = __byte_perm(f[0], f[2], 0x7632);
  o = __byte_perm(f[1], f[3], 0x7632);
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &h, sizeof u);
  return u;
}

// Fill ring stage st with k0 .. k0 + TC_BK: the x slab's rows 0 .. rows -
// 1 (rows past M zero-filled) and the weight slab of columns n0 ..
// n0 + BN.
template <bool XBF, int CG>
__device__ __forceinline__ void tc_load(const TcArgs& a, unsigned char* st,
                                        int m0, int rows, int n0, int k0) {
  using T = Tc<CG>;
  const int t = threadIdx.x;
  constexpr int EB = XBF ? 2 : 4, EPP = 16 / EB, PPR = TC_BK / EPP;
  const char* x = reinterpret_cast<const char*>(a.x);
  // a piece is EPP elements at k (a multiple of EPP); K % 16 == 0, so a
  // piece is wholly below K or wholly past it
  for (int i = t; i < rows * PPR; i += T::THREADS) {
    const int r = i / PPR, p = i % PPR, k = k0 + p * EPP;
    const bool ok = m0 + r < a.M && k < a.K;
    cp_async16_zf(st + r * (TC_XS * EB) + 16 * p,
                  ok ? x + ((long)(m0 + r) * a.K + k) * EB : x, ok ? 16 : 0);
  }
  unsigned char* ws = st + T::template xbytes<XBF>();
  const char* w = reinterpret_cast<const char*>(a.w);
  if (a.w16) {
    constexpr int P = T::BN / 16;
#pragma unroll
    for (int i = t; i < TC_BK * P; i += T::THREADS) {
      const int r = i / P, p = i % P, k = k0 + r, n = n0 + 16 * p;
      const bool ok = k < a.K && n < a.N;
      cp_async16_zf(ws + r * T::WS + 16 * p,
                    ok ? w + (long)k * a.N + n : w, ok ? 16 : 0);
    }
  } else {
    constexpr int P = T::BN / 8;
    for (int i = t; i < TC_BK * P; i += T::THREADS) {
      const int r = i / P, p = i % P, k = k0 + r, n = n0 + 8 * p;
      const bool ok = k < a.K && n < a.N;
      cp_async8_zf(ws + r * T::WS + 8 * p,
                   ok ? w + (long)k * a.N + n : w, ok ? 8 : 0);
    }
  }
}

// x fragment of the m16 tile at row0, k .. k + 15
template <bool XBF>
__device__ __forceinline__ void tc_afrag(const unsigned char* xs, int row0,
                                         int k, int lane, uint32_t af[4]) {
  if (XBF) {
    // matrix j = lane / 8: rows 8 (j & 1) .., k 8 (j >> 1) ..
    const __nv_bfloat16* p = reinterpret_cast<const __nv_bfloat16*>(xs) +
                             (row0 + (lane & 15)) * TC_XS + k +
                             8 * (lane >> 4);
    ldsm_x4(af, p);
  } else {
    const float* p = reinterpret_cast<const float*>(xs) +
                     (row0 + (lane >> 2)) * TC_XS + k + 2 * (lane & 3);
    const float2 v0 = *reinterpret_cast<const float2*>(p);
    const float2 v1 = *reinterpret_cast<const float2*>(p + 8 * TC_XS);
    const float2 v2 = *reinterpret_cast<const float2*>(p + 8);
    const float2 v3 = *reinterpret_cast<const float2*>(p + 8 * TC_XS + 8);
    af[0] = bf16x2(v0.x, v0.y);
    af[1] = bf16x2(v1.x, v1.y);
    af[2] = bf16x2(v2.x, v2.y);
    af[3] = bf16x2(v3.x, v3.y);
  }
}

// acc[mt][2 s] / [2 s + 1]: the even / odd columns' n8 tile of the warp's
// 16-column group s (0, 1) in m16 tile mt
template <bool XBF, int CG>
__device__ __forceinline__ void tc_compute(const unsigned char* st,
                                           int mtiles, float acc[4][4][4]) {
  using T = Tc<CG>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned char* ws =
      st + T::template xbytes<XBF>() + 32 * (warp % CG);
#pragma unroll
  for (int k32 = 0; k32 < T::KW; k32 += 32) {
    const int kk = (warp / CG) * T::KW + k32;
    // matrix j of group s: k rows kk + 8 j .. + 7 of columns 16 s .. + 15
    uint32_t be[2][4], bo[2][4];
#pragma unroll
    for (int sg = 0; sg < 2; ++sg) {
      uint32_t b[4];
      ldsm_x4_trans(b, ws + (kk + lane) * T::WS + 16 * sg);
#pragma unroll
      for (int j = 0; j < 4; ++j) i8x4_bf16(b[j], be[sg][j], bo[sg][j]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        if (mt < mtiles) {
          uint32_t af[4];
          tc_afrag<XBF>(st, 16 * mt, kk + 16 * h, lane, af);
#pragma unroll
          for (int sg = 0; sg < 2; ++sg) {
            mma_bf16(acc[mt][2 * sg], af, be[sg][2 * h], be[sg][2 * h + 1]);
            mma_bf16(acc[mt][2 * sg + 1], af, bo[sg][2 * h],
                     bo[sg][2 * h + 1]);
          }
        }
      }
    }
  }
}

template <bool XBF, int CG>
__global__ void __launch_bounds__(32 * CG * TC_KG) qtile_kernel(TcArgs a) {
  using T = Tc<CG>;
  extern __shared__ __align__(16) unsigned char smem[];
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = a.cs, c = (int)cluster.block_rank();
  const int n0 = (int)(blockIdx.x / cs) * T::BN, m0 = blockIdx.y * TC_BM;
  const int mv = min(TC_BM, a.M - m0);        // rows of this tile
  const int mtiles = (mv + 15) >> 4;          // m16 tiles computed
  const int slabs = (a.K + TC_BK - 1) / TC_BK;
  const int s0 = c * slabs / cs, ns = (c + 1) * slabs / cs - s0;
  constexpr int SB = T::template stage<XBF>();

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 4; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][h][j] = 0.f;

  // the ring: slab i in stage i % TC_STAGES, TC_STAGES - 1 in flight
#pragma unroll
  for (int i = 0; i < TC_STAGES - 1; ++i) {
    if (i < ns)
      tc_load<XBF, CG>(a, smem + i * SB, m0, 16 * mtiles, n0,
                           (s0 + i) * TC_BK);
    cp_async_commit();
  }
  for (int i = 0; i < ns; ++i) {
    cp_async_wait<TC_STAGES - 2>();  // slab i has landed
    __syncthreads();                 // and slab i - 1's stage is free
    const int nx = i + TC_STAGES - 1;
    if (nx < ns)
      tc_load<XBF, CG>(a, smem + (nx % TC_STAGES) * SB, m0,
                           16 * mtiles, n0, (s0 + nx) * TC_BK);
    cp_async_commit();
    tc_compute<XBF, CG>(smem + (i % TC_STAGES) * SB, mtiles, acc);
  }
  cp_async_wait<0>();
  __syncthreads();

  // the partial tiles, through distributed shared memory, to the ranks
  // that own their columns (rank q the columns [q CW, (q + 1) CW) of the
  // tile), into their slot c TC_KG + (k-group) (over the ring): thread (g, t)
  // of a warp holds columns 16 s + 4 t .. + 3 of its 32 (s = 0, 1) of
  // rows g and g + 8 of each m16 tile, as even, odd, even, odd
  const int CW = T::BN / cs, RS = CW + 4;   // a slot's columns, row stride
  float* part = reinterpret_cast<float*>(smem);
  cluster_arrive_relaxed();  // every rank has left its ring
  cluster_wait();
  {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, slot = c * TC_KG + warp / CG;
#pragma unroll
    for (int sg = 0; sg < 2; ++sg) {
      const int col = 32 * (warp % CG) + 16 * sg + 4 * (lane & 3);
      float* dst = cluster.map_shared_rank(part, col / CW) +
                   slot * TC_BM * RS + col % CW;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        if (mt < mtiles) {
          const float* e = acc[mt][2 * sg];
          const float* o = acc[mt][2 * sg + 1];
          const int r = 16 * mt + g;
          *reinterpret_cast<float4*>(dst + r * RS) =
              make_float4(e[0], o[0], e[1], o[1]);
          *reinterpret_cast<float4*>(dst + (r + 8) * RS) =
              make_float4(e[2], o[2], e[3], o[3]);
        }
      }
    }
  }
  cluster_arrive();
  cluster_wait();

  // this rank's columns, 4 at a time: the partials added in slot order
  // (rank 0's k-groups, rank 1's, ...), then * scale[n]
  for (int e = threadIdx.x; e < mv * (CW / 4); e += T::THREADS) {
    const int r = e / (CW / 4), c4 = 4 * (e % (CW / 4));
    const int n = n0 + c * CW + c4;
    if (n < a.N) {  // N % 8 == 0: the 4 columns are all below N
      const float* pr = part + r * RS + c4;
      float4 v = *reinterpret_cast<const float4*>(pr);
      for (int q = 1; q < cs * TC_KG; ++q) {
        const float4 p = *reinterpret_cast<const float4*>(pr + q * TC_BM * RS);
        v.x = __fadd_rn(v.x, p.x);
        v.y = __fadd_rn(v.y, p.y);
        v.z = __fadd_rn(v.z, p.z);
        v.w = __fadd_rn(v.w, p.w);
      }
      v.x = __fmul_rn(v.x, a.scale[n]);
      v.y = __fmul_rn(v.y, a.scale[n + 1]);
      v.z = __fmul_rn(v.z, a.scale[n + 2]);
      v.w = __fmul_rn(v.w, a.scale[n + 3]);
      *reinterpret_cast<float4*>(a.out + (long)(m0 + r) * a.N + n) = v;
    }
  }
}

// the K split: the fewest blocks a cluster (at most 8, each rank at least
// one slab) that put TC_MIN_BLOCKS in flight
inline int tc_cluster(int tiles, int slabs) {
  int cs = 1;
  while (cs < 8 && tiles * cs < TC_MIN_BLOCKS && 2 * cs <= slabs) cs *= 2;
  return cs;
}

template <bool XBF, int CG>
cudaError_t launch_tile(TcArgs a, cudaStream_t st) {
  using T = Tc<CG>;
  const int tn = (a.N + T::BN - 1) / T::BN, tm = (a.M + TC_BM - 1) / TC_BM;
  const int slabs = (a.K + TC_BK - 1) / TC_BK;
  a.cs = tc_cluster(tn * tm, slabs);
  // the ring's stages that a rank fills (at most a rank's slabs), or the
  // cs TC_KG slots of partials (TC_BM rows of BN / cs + 4 floats) if larger
  const auto slots = [](int cs) {
    return TC_KG * TC_BM * (T::BN + 4 * cs) * (int)sizeof(float);
  };
  constexpr int ring = TC_STAGES * T::template stage<XBF>();
  const int used = min(TC_STAGES, (slabs + a.cs - 1) / a.cs);
  const int smem = max(used * T::template stage<XBF>(), slots(a.cs));
  static std::atomic<unsigned> smem_set{0};  // one per instantiation
  const cudaError_t e =
      allow_smem(qtile_kernel<XBF, CG>, max(ring, slots(8)), smem_set);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = a.cs;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tn * a.cs, tm);
  cfg.blockDim = dim3(T::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, qtile_kernel<XBF, CG>, a);
}

// The tile's width: 128 columns in 8 warps where that needs a K split of
// exactly 2 blocks, else 64 columns in 4 warps.
inline bool tc_wide(int M, int K, int N) {
  const int tiles = (M + TC_BM - 1) / TC_BM * ((N + 127) / 128);
  return tc_cluster(tiles, (K + TC_BK - 1) / TC_BK) == 2;
}

template <bool XBF>
cudaError_t launch_tile_any(const TcArgs& a, cudaStream_t st) {
  const auto aligned = [](const void* p, unsigned b) {
    return reinterpret_cast<uintptr_t>(p) % b == 0;
  };
  if (a.M < 1 || a.K < 16 || a.K % 16 != 0 || a.N < 8 || a.N % 8 != 0 ||
      (a.M + TC_BM - 1) / TC_BM > 65535 || !aligned(a.x, 16) ||
      !aligned(a.w, 8) || !aligned(a.out, 16))
    return cudaErrorInvalidValue;
  TcArgs b = a;
  b.w16 = a.N % 16 == 0 && aligned(a.w, 16);
  return tc_wide(a.M, a.K, a.N) ? launch_tile<XBF, 4>(b, st)
                                 : launch_tile<XBF, 2>(b, st);
}

}  // namespace

// the tensor-core tile: M >= 1 rows, N % 8 == 0, K % 16 == 0
extern "C" int q3_qmatmul_tile(const void* x, int x_bf16, const void* q,
                               const void* scale, void* out, int M, int K,
                               int N, void* stream) {
  TcArgs a = {};
  a.x = x;
  a.w = reinterpret_cast<const int8_t*>(q);
  a.scale = reinterpret_cast<const float*>(scale);
  a.out = reinterpret_cast<float*>(out);
  a.M = M; a.K = K; a.N = N;
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const cudaError_t e =
      x_bf16 ? launch_tile_any<true>(a, st) : launch_tile_any<false>(a, st);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// qsplit: rows x (M <= 8, K) through nseg <= 3 dense int8 weights (K, N_i)
// that share them, out_i (M, N_i) f32 = qmm(x, w_i, scale_i), one launch
extern "C" int q3_qmatmul_split(const void* x, int x_bf16, int M, int K,
                                int nseg, const void* w0, const void* s0,
                                void* o0, int N0, const void* w1,
                                const void* s1, void* o1, int N1,
                                const void* w2, const void* s2, void* o2,
                                int N2, void* stream) {
  if (nseg < 1 || nseg > QS_MAXSEG) return (int)cudaErrorInvalidValue;
  const void* w[QS_MAXSEG] = {w0, w1, w2};
  const void* s[QS_MAXSEG] = {s0, s1, s2};
  void* o[QS_MAXSEG] = {o0, o1, o2};
  const int N[QS_MAXSEG] = {N0, N1, N2};
  Product p(M, K, 0.f);
  p.rows(x, x_bf16, K);
  for (int i = 0; i < nseg; ++i)
    p.seg(w[i], reinterpret_cast<const float*>(s[i]), o[i], N[i], N[i]);
  return (int)launch_qsplit<PRO_PLAIN, int8_t, EPI_STORE_F32>(
      p.a, reinterpret_cast<cudaStream_t>(stream));
}

extern "C" const char* q3_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
