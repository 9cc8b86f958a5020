// K5: one-token GQA decode attention over the dense KV cache; K4: the
// same over a block-paged KV pool through a per-row page table; K6: the
// same over a per-row scaled int8 cache. One kernel body; compile-time
// modes say how a position's row is found and how it is read.
//
// Replaces the TPU kernels qwen3_tts_tpu/ops/pallas/decode_attention.py ::
// decode_attention_pallas (K5), qwen3_tts_tpu/ops/pallas/
// paged_attention.py :: paged_decode_attention_pallas (K4) and
// qwen3_tts_tpu/ops/pallas/kv_int8.py :: decode_attention_kv_int8 (K6).
//
// out[b, h*G + g, :] = softmax_s(q[b, h*G + g] . K[b, s, h] * scale, s <=
// pos[b]) . V[b, :, h], with q, K and V read as f32 (from bf16 or f32),
// all arithmetic in f32, the output stored in q's dtype. Keys past pos are
// not read: the TPU kernels mask them at -1e30, where exp underflows to
// exactly 0 in f32, so leaving them out changes no bit of the softmax.
// Dense (K5): row b's position s is K[b, s] of a (B, S, Hkv, Dh) cache.
// Paged (K4): it is pool[table[b, s / psz], s % psz] of a (P, psz, Hkv, Dh)
// pool, S = MAXP * psz; table entries past a row's allocation are 0, a
// reserved page, and since no position past pos is read, never read.
// int8 (K6): it is kq[b, h, s] of a head-major (B, Hkv, S, Dh) int8 cache
// with f32 row scales ks[b, h, s], each element dequantized as float(kq) *
// ks in f32, one correctly rounded product (the TPU kernel's dequantize),
// before it is used; V likewise.
//
// Bound on an H100: a call reads each row's K and V for positions 0..pos
// once (2 x (pos+1) x Hkv x Dh elements; at B = 4, S = 512, bf16 and pos
// [0, 511, 200, 37], 3.1 MB, 0.93 us at 3.35 TB/s; at B = 8 and every pos
// 511, 16.8 MB, 5.0 us; int8, 2 x (pos+1) x Hkv x (Dh + 4) bytes with the
// scales, 1.6 MB and 0.47 us, 8.7 MB and 2.6 us) against ~4 flops per
// element: bound by HBM bandwidth, so the design is about keeping bytes in
// flight and the serial steps after them short.
//
// Design. The positions of a (kv head, row) are split over a cluster of
// DA_NSPLIT = 8 blocks (grid (8, Hkv, B): 256 blocks at B = 4 where one
// block per (kv head, row) gave 32). Block c takes the chunk of positions
// [c*C, c*C + C), C = ceil(S / 8) (a function of S only: no host sync, and
// a CUDA graph can capture the call), and each of its DA_WARPS = 4 warps
// the sub-chunk [c*C + w*W, c*C + w*W + W), W = ceil(C / 4). A block or
// warp whose positions start past pos loads nothing. Paged, each warp
// first turns its positions into pool rows, one table entry a position
// read while pos is read (a sub-chunk may straddle page edges: the lookup
// is per position). Before it computes
// anything, each warp issues cp.async copies, 16 bytes a lane, of its K
// rows and V rows into its own ring of shared-memory buffers (longer
// sub-chunks are walked in tiles, K tiles first), so the V read overlaps
// the scores, and the warp then runs alone (__syncwarp only). int8, the
// cache is head-major, so a warp's K rows and its V rows are each one
// contiguous run of W * Dh bytes (2 KB at S = 512), 64 rows of 128 a
// staging buffer; their W row scales each go 4 bytes a copy (s0 * 4 is
// not 16-byte aligned for every S) into the warp's scale buffer, in the
// first copy group. Per query head g of the group, over the warp's
// positions s <= pos:
//   score   lane chains of 8 contiguous elements (Dh / 8 lanes a row, one
//           16-byte shared load in bf16, one 8-byte load of int8, each
//           element then float(kq) * ks by __fmul_rn: nvcc's -fmad must
//           not contract it into the chain's fma), an xor butterfly over
//           those lanes, then * scale;
//   m_w     max of the scores; e_s = expf(s - m_w);
//   l_w     sum of e_s: lane j adds positions j, j + 32, ... in order,
//           then a warp butterfly;
//   o_w[d]  sum of e_s * v[s, d], one fma chain in position order (a lane
//           owns 8 contiguous outputs of a head).
// Partials (m, l, o) merge in a fixed order: M = max m_i, w_i = expf(m_i -
// M), L = sum_i l_i * w_i and O = sum_i w_i * o_i, each sum an fma chain in
// index order. The block merges its live warps into (m_c, l_c, o_c) and
// stores each output's partial into the shared memory of the rank that
// combines it (rank r owns outputs [r * per, r * per + per), per = ceil(G *
// Dh / 8)), and (m_c, l_c) into every rank, through distributed shared
// memory. One cluster barrier (arrive with release, wait with acquire)
// later, every rank merges its outputs over the live blocks c = 0 .. pos /
// C from its own shared memory and stores O / L, correctly rounded. (A
// relaxed arrive as the block starts, waited on before the first remote
// store, makes sure every block of the cluster is running by then.) One
// launch, no global scratch, no score array of size S (W floats per head
// and warp). The plain version (ops/kernels/decode_attention.py) follows
// every one of these orders, so the two agree bit for bit; K4's plain
// version (ops/kernels/paged_attention.py) is K5's over the rows the table
// gathers, K6's (ops/kernels/kv_int8.py) K5's over the dequantized rows.
//
// What sets the time: at these sizes not the bytes but each block's chain
// of dependent steps (the pos load, the copies, scores, softmax, P.V, the
// merge, the barrier, the combine), so the talker's group size and head
// dim (G 2, Dh 128) are template constants, which folds the index
// arithmetic of the main path; every other (G <= 8, Dh) takes one generic
// instantiation, in each of the dense, paged and int8 modes. S is read at
// run time. q rows are read 16 bytes a lane. The int8 mode is added behind
// `if constexpr` and constant-folded selects, so the bf16 and f32
// instantiations compile as they did before it.
// Times and bounds are in PERF.md
// (qwen3_tts_tpu_torch/tools/bench_decode_attention).
#include "common.cuh"

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int DA_NSPLIT = 8;     // blocks (splits) per (kv head, row): a cluster
constexpr int DA_WARPS = 4;      // sub-chunks a block: one warp each
constexpr int DA_THREADS = 32 * DA_WARPS;
constexpr int DA_MAXG = 8;       // query heads per kv head
constexpr int DA_VEC = 8;        // elements of a lane's dot chain
constexpr int DA_MAXDH = 256;    // Dh / DA_VEC lanes a row: a power of two <= 32
constexpr int DA_NBUF = 2;       // staging buffers a warp
// bytes of K or V rows a buffer: a warp's sub-chunk of up to 32 bf16 rows
// (64 int8 rows) of 128 (the paged batcher's 18 of 576 positions, K5's and
// K6's 16 of 512) is one K stage and one V stage, all in flight at once
constexpr int DA_TILE_BYTES = 8 * 1024;
constexpr int DA_MAX_SMEM = 227 * 1024;

// 8 contiguous staged elements as f32
__device__ __forceinline__ void ld8(const __nv_bfloat16* p, float v[8]) {
  load8<__nv_bfloat16>(p, 0, v);
}

__device__ __forceinline__ void ld8(const float* p, float v[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// 8 contiguous staged int8 elements of a row whose scale is rs, each
// dequantized as float(kq) * rs: one 8-byte shared load, two char4s, and
// an explicit __fmul_rn, so the product is rounded before any fma uses it
__device__ __forceinline__ void ld8(const int8_t* p, float rs, float v[8]) {
  const int2 raw = *reinterpret_cast<const int2*>(p);
  char4 a, b;
  memcpy(&a, &raw.x, sizeof a);
  memcpy(&b, &raw.y, sizeof b);
  v[0] = __fmul_rn((float)a.x, rs); v[1] = __fmul_rn((float)a.y, rs);
  v[2] = __fmul_rn((float)a.z, rs); v[3] = __fmul_rn((float)a.w, rs);
  v[4] = __fmul_rn((float)b.x, rs); v[5] = __fmul_rn((float)b.y, rs);
  v[6] = __fmul_rn((float)b.z, rs); v[7] = __fmul_rn((float)b.w, rs);
}

struct DaArgs {
  const void* q; int q_bf16;
  const void* k; const void* v;  // dense (B, S, Hkv, Dh); paged pools (P,
                                 // psz, Hkv, Dh); f32 or bf16 (KV); int8
                                 // (B, Hkv, S, Dh)
  const void* pos; int pos64;    // (B,) int32, or int64 if pos64
  const int* table; int MAXP, psz;  // paged: (B, MAXP) page ids, S = MAXP * psz
  void* out;                     // (B, Hq * Dh) in q's type
  int S, Hq, Hkv, Dh;
  int tile;                      // rows a staging buffer holds
  float scale;
  const float* ks; const float* vs;  // int8: (B, Hkv, S) row scales
};

// shared-memory words (f32, or int for the pool rows) after the staging
// rings: a warp's scores, every warp's (m, l) and P.V, the slices of every
// block's (m, l) and P.V that this block combines, and ``tail`` words a
// warp: (paged) its pool rows, (int8) its K and V row scales
inline int da_smem_words(int G, int Dh, int W, int tail) {
  const int per = (G * Dh + DA_NSPLIT - 1) / DA_NSPLIT;
  return DA_WARPS * (G * W + 2 * G + G * Dh) + DA_NSPLIT * (per + 2 * G) +
         DA_WARPS * tail;
}

// MAIN: the talker's G 2 and Dh 128 as constants; otherwise G <= 8 and
// Dh come from the arguments, with registers for 8 heads. PAGED: rows
// through the page table (K4), else the dense cache (K5). KV int8_t (K6,
// never PAGED): the head-major int8 cache with its row scales.
template <typename KV, bool MAIN, bool PAGED>
__global__ void __cluster_dims__(DA_NSPLIT, 1, 1) __launch_bounds__(DA_THREADS)
decode_attn_split_kernel(DaArgs a) {
  constexpr bool I8 = std::is_same<KV, int8_t>::value;
  static_assert(!(I8 && PAGED), "no paged int8 cache");
  constexpr int GM = MAIN ? 2 : DA_MAXG;            // registers: q rows
  constexpr int NV = GM * DA_MAXDH / DA_VEC / 32;  // P.V units a lane
  constexpr int R = GM <= 2 ? 4 : (GM == 4 ? 2 : 1);  // score rows at once
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();
  const int S = a.S, Dh = MAIN ? 128 : a.Dh, Hq = a.Hq, Hkv = a.Hkv;
  const KV* k = reinterpret_cast<const KV*>(a.k);
  const KV* v = reinterpret_cast<const KV*>(a.v);
  const int G = MAIN ? GM : Hq / Hkv, GD = G * Dh;
  const int C = (S + DA_NSPLIT - 1) / DA_NSPLIT, W = (C + DA_WARPS - 1) / DA_WARPS;
  const int tile = a.tile;  // rows a staging buffer holds
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;  // c: cluster rank
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long qbase = ((long)b * Hq + (long)h * G) * Dh;  // [b, h * G, 0]
  // lane gl of row group grp holds q[g, 8 gl .. 8 gl + 7] of every head g
  // (loaded first: it does not wait for pos)
  const int lpr = Dh / DA_VEC, ngrp = 32 / lpr;
  const int grp = lane / lpr, gl = lane - grp * lpr;
  float qr[GM][DA_VEC];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    const long i = qbase + g * Dh + gl * DA_VEC;  // 16-byte aligned
    if (g >= G) {
#pragma unroll
      for (int j = 0; j < DA_VEC; ++j) qr[g][j] = 0.f;
    } else if (a.q_bf16) {
      ld8(reinterpret_cast<const __nv_bfloat16*>(a.q) + i, qr[g]);
    } else {
      ld8(reinterpret_cast<const float*>(a.q) + i, qr[g]);
    }
  }

  const long long pb = a.pos64 ? reinterpret_cast<const long long*>(a.pos)[b]
                               : reinterpret_cast<const int*>(a.pos)[b];
  const int p = (int)min(max(pb, 0LL), (long long)(S - 1));
  const int c0 = c * C, s0 = c0 + warp * W;  // the warp's first position
  const int n = max(0, min(C, p + 1 - c0));    // the block's positions <= p
  const int nw = max(0, min(W, n - warp * W));  // the warp's
  // shared: ring[DA_WARPS][DA_NBUF][tile * Dh] | sc[DA_WARPS][G * W] |
  // wml[DA_WARPS][2 G] | wo[DA_WARPS][G * Dh] | ro[DA_NSPLIT][per] |
  // rml[DA_NSPLIT][2 G] | (paged) prow[DA_WARPS][W] | (int8)
  // rsc[DA_WARPS][2 W], a warp's K then V row scales; rank c combines
  // outputs [c * per, c * per + per)
  const int per = (GD + DA_NSPLIT - 1) / DA_NSPLIT;
  KV* ring = reinterpret_cast<KV*>(smem) + warp * DA_NBUF * tile * Dh;
  float* sc = reinterpret_cast<float*>(reinterpret_cast<KV*>(smem) +
                                       DA_WARPS * DA_NBUF * tile * Dh);
  float* wml = sc + DA_WARPS * G * W;
  float* wo = wml + DA_WARPS * 2 * G;
  float* ro = wo + DA_WARPS * GD;
  float* rml = ro + DA_NSPLIT * per;
  int* prow = reinterpret_cast<int*>(rml + DA_NSPLIT * 2 * G) + warp * W;
  float* ksc = I8 ? rml + DA_NSPLIT * 2 * G + warp * 2 * W : nullptr;
  float* vsc = I8 ? ksc + W : nullptr;
  sc += warp * G * W;

  // paged: the pool row of each of the warp's positions below S (its
  // table entry does not wait for pos; entries past pos name pages that
  // are then never read)
  if (PAGED) {
    const int* tb = a.table + (long)b * a.MAXP;
    for (int j = lane; j < min(W, S - s0); j += 32) {
      const int s = s0 + j;
      prow[j] = tb[s / a.psz] * a.psz + s % a.psz;
    }
    __syncwarp();
  }

  const long KVD = I8 ? (long)Dh : (long)Hkv * Dh;  // a row's stride
  // dense: row b's position s0 + r at base + r * KVD; paged: pool row
  // prow[r] at prow[r] * KVD + h * Dh; int8: [b, h, s0 + r] at base + r * Dh
  const long base = PAGED ? (long)h * Dh
                    : I8  ? (((long)b * Hkv + h) * S + s0) * Dh
                          : ((long)b * S + s0) * KVD + (long)h * Dh;
  const int nt = (nw + tile - 1) / tile, nst = 2 * nt;  // K tiles, then V
  const int ppr = Dh * (int)sizeof(KV) / 16;  // 16-byte pieces a row: 2^k
  const int pshift = __ffs(ppr) - 1;

  auto issue = [&](int st) {
    const bool is_v = st >= nt;
    const int r0 = (is_v ? st - nt : st) * tile, rows = min(tile, nw - r0);
    const KV* src = (is_v ? v : k) + base + (PAGED ? 0 : (long)r0 * KVD);
    KV* dst = ring + (st % DA_NBUF) * tile * Dh;
    for (int i = lane; i < rows * ppr; i += 32) {
      const int r = i >> pshift, j = i & (ppr - 1);
      const long row = PAGED ? (long)prow[r0 + r] * KVD : (long)r * KVD;
      cp_async16(reinterpret_cast<char*>(dst + r * Dh) + 16 * j,
                 reinterpret_cast<const char*>(src + row) + 16 * j);
    }
  };
  if constexpr (I8) {  // the warp's row scales, in the first group
    const long sb = ((long)b * Hkv + h) * S + s0;
    for (int j = lane; j < nw; j += 32) {
      cp_async4(ksc + j, a.ks + sb + j);
      cp_async4(vsc + j, a.vs + sb + j);
    }
  }
#pragma unroll
  for (int st = 0; st < DA_NBUF; ++st) {  // one commit group a stage
    if (st < nst) issue(st);
    cp_async_commit();
  }

  float acc[NV][DA_VEC];  // o_w of outputs 8 (lane + 32 i) + j
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int j = 0; j < DA_VEC; ++j) acc[i][j] = 0.f;

  for (int st = 0; st < nst; ++st) {
    cp_async_wait<DA_NBUF - 1>();  // stage st has landed
    __syncwarp();
    const KV* buf = ring + (st % DA_NBUF) * tile * Dh;
    if (st < nt) {
      // scores of K tile st: each lane group takes R rows at a time (its
      // rows' loads, fma chains and butterflies interleaved); the trip
      // count is uniform over the warp, so every shuffle has all lanes
      const int r0 = st * tile, rows = min(tile, nw - r0);
      for (int rb = 0; rb < rows; rb += R * ngrp) {
        float kv8[R][DA_VEC], d[R][GM];
#pragma unroll
        for (int u = 0; u < R; ++u) {  // rows past the tile repeat its last
          const int rr = min(rb + u * ngrp + grp, rows - 1);
          if constexpr (I8)
            ld8(buf + rr * Dh + gl * DA_VEC, ksc[r0 + rr], kv8[u]);
          else
            ld8(buf + rr * Dh + gl * DA_VEC, kv8[u]);
        }
#pragma unroll
        for (int u = 0; u < R; ++u)
#pragma unroll
          for (int g = 0; g < GM; ++g) {
            d[u][g] = 0.f;
#pragma unroll
            for (int j = 0; j < DA_VEC; ++j)
              d[u][g] = fmaf(qr[g][j], kv8[u][j], d[u][g]);
          }
        for (int o = lpr >> 1; o > 0; o >>= 1)
#pragma unroll
          for (int u = 0; u < R; ++u)
#pragma unroll
            for (int g = 0; g < GM; ++g)
              d[u][g] += __shfl_xor_sync(0xffffffffu, d[u][g], o);
        if (gl == 0)
#pragma unroll
          for (int u = 0; u < R; ++u) {
            const int r = rb + u * ngrp + grp;
#pragma unroll
            for (int g = 0; g < GM; ++g)
              if (r < rows && g < G)
                sc[g * W + r0 + r] = __fmul_rn(d[u][g], a.scale);
          }
      }
    } else {
      if (st == nt) {
        // every score of the warp is in: m_w, e_s and l_w per head
        for (int g = 0; g < G; ++g) {
          float* s = sc + g * W;
          float m = -INFINITY;
          for (int j = lane; j < nw; j += 32) m = fmaxf(m, s[j]);
          m = warp_max(m);
          float l = 0.f;
          for (int j = lane; j < nw; j += 32) {
            const float e = expf(s[j] - m);
            s[j] = e;
            l += e;
          }
          l = warp_sum(l);
          if (lane == 0) {
            wml[warp * 2 * G + g] = m;
            wml[warp * 2 * G + G + g] = l;
          }
        }
        __syncwarp();
      }
      // P.V over V tile st - nt: one fma chain per output in position
      // order; 8 contiguous V elements a load
      const int r0 = (st - nt) * tile, rows = min(tile, nw - r0);
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int u = lane + 32 * i;  // (g, lane group) = (u / lpr, u % lpr)
        if (u < G * lpr) {
          const float* e = sc + (u / lpr) * W + r0;
          const KV* vr = buf + (u % lpr) * DA_VEC;
#pragma unroll 4
          for (int r = 0; r < rows; ++r) {
            float v8[DA_VEC];
            if constexpr (I8)
              ld8(vr + r * Dh, vsc[r0 + r], v8);
            else
              ld8(vr + r * Dh, v8);
            const float er = e[r];
#pragma unroll
            for (int j = 0; j < DA_VEC; ++j) acc[i][j] = fmaf(er, v8[j], acc[i][j]);
          }
        }
      }
    }
    __syncwarp();  // buffer st % DA_NBUF consumed
    if (st + DA_NBUF < nst) issue(st + DA_NBUF);
    cp_async_commit();
  }
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int u = lane + 32 * i;
    if (u < G * lpr)
#pragma unroll
      for (int j = 0; j < DA_VEC; ++j)
        wo[warp * GD + (u / lpr) * Dh + (u % lpr) * DA_VEC + j] = acc[i][j];
  }
  __syncthreads();

  // the block's partial: its live warps 0 .. (n - 1) / W merged in order,
  // each output sent to the rank that combines it, (m, l) to every rank
  cluster_wait();  // every block of the cluster has started
  const int nwl = (n + W - 1) / W;
  for (int o = t; o < GD && nwl > 0; o += DA_THREADS) {
    const int g = o / Dh;
    float M = -INFINITY;
    for (int w = 0; w < nwl; ++w) M = fmaxf(M, wml[w * 2 * G + g]);
    float L = 0.f, x = 0.f;
    for (int w = 0; w < nwl; ++w) {
      const float ww = expf(wml[w * 2 * G + g] - M);
      L = fmaf(wml[w * 2 * G + G + g], ww, L);
      x = fmaf(ww, wo[w * GD + o], x);
    }
    const int r = o / per;
    cluster.map_shared_rank(ro, r)[c * per + o - r * per] = x;
    if (o == g * Dh) {
#pragma unroll
      for (int r2 = 0; r2 < DA_NSPLIT; ++r2) {
        float* dst = cluster.map_shared_rank(rml, r2) + c * 2 * G;
        dst[g] = M;
        dst[G + g] = L;
      }
    }
  }
  cluster_arrive();
  cluster_wait();

  // combine: this rank's outputs over the live blocks 0 .. p / C, merged
  // in rank order
  const int nc = p / C + 1;
  for (int i = t; i < per && c * per + i < GD; i += DA_THREADS) {
    const int o = c * per + i, g = o / Dh;
    float M = -INFINITY;
    for (int r = 0; r < nc; ++r) M = fmaxf(M, rml[r * 2 * G + g]);
    float L = 0.f, sum = 0.f;
    for (int r = 0; r < nc; ++r) {
      const float w = expf(rml[r * 2 * G + g] - M);
      L = fmaf(rml[r * 2 * G + G + g], w, L);
      sum = fmaf(w, ro[r * per + i], sum);
    }
    stf(a.out, qbase + o, a.q_bf16, __fdiv_rn(sum, L));
  }
}

template <typename KV, bool MAIN, bool PAGED>
cudaError_t launch_decode_attn(const DaArgs& a, int B, size_t smem,
                               cudaStream_t st) {
  if (smem > 48 * 1024) {  // per device: set on every call, it is cheap
    cudaError_t e = cudaFuncSetAttribute(
        decode_attn_split_kernel<KV, MAIN, PAGED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  decode_attn_split_kernel<KV, MAIN, PAGED>
      <<<dim3(DA_NSPLIT, a.Hkv, B), DA_THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename KV, bool PAGED>
cudaError_t launch_kv(const DaArgs& a, int B, size_t smem, cudaStream_t st) {
  return a.Hq == 2 * a.Hkv && a.Dh == 128
             ? launch_decode_attn<KV, true, PAGED>(a, B, smem, st)
             : launch_decode_attn<KV, false, PAGED>(a, B, smem, st);
}

// the K/V element types of launch_attention
enum DaKv { DA_F32 = 0, DA_BF16 = 1, DA_I8 = 2 };

// checks, staging tile and shared memory of every mode, then the launch
cudaError_t launch_attention(DaArgs a, int kv, int B, bool paged,
                             cudaStream_t st) {
  const int S = a.S, Hq = a.Hq, Hkv = a.Hkv, Dh = a.Dh;
  const int lpr = Dh / DA_VEC;
  const size_t es = kv == DA_I8 ? 1 : kv == DA_BF16 ? 2 : 4;
  // q rows are read and K/V rows copied in 16-byte pieces: q, k, v and
  // every row (Dh elements) must keep that alignment
  if (B < 1 || S < 1 || Hkv < 1 || Hq % Hkv || Hq / Hkv > DA_MAXG ||
      Dh < DA_VEC || Dh % DA_VEC || Dh > DA_MAXDH || (lpr & (lpr - 1)) ||
      (Dh * es) % 16 || (kv == DA_I8 && (paged || !a.ks || !a.vs)) ||
      reinterpret_cast<uintptr_t>(a.q) % 16 ||
      reinterpret_cast<uintptr_t>(a.k) % 16 ||
      reinterpret_cast<uintptr_t>(a.v) % 16)
    return cudaErrorInvalidValue;
  const int G = Hq / Hkv, C = (S + DA_NSPLIT - 1) / DA_NSPLIT;
  const int W = (C + DA_WARPS - 1) / DA_WARPS;
  const int fit = (int)(DA_TILE_BYTES / (Dh * es));  // rows a buffer holds
  a.tile = W < fit ? W : fit;
  const int tail = paged ? W : kv == DA_I8 ? 2 * W : 0;
  const size_t smem = DA_WARPS * DA_NBUF * (size_t)a.tile * Dh * es +
                      (size_t)da_smem_words(G, Dh, W, tail) * 4;
  if (smem > (size_t)DA_MAX_SMEM) return cudaErrorInvalidValue;
  if (paged)
    return kv == DA_BF16 ? launch_kv<__nv_bfloat16, true>(a, B, smem, st)
                         : launch_kv<float, true>(a, B, smem, st);
  if (kv == DA_I8) return launch_kv<int8_t, false>(a, B, smem, st);
  return kv == DA_BF16 ? launch_kv<__nv_bfloat16, false>(a, B, smem, st)
                       : launch_kv<float, false>(a, B, smem, st);
}

}  // namespace

// K5: k, v the dense cache (B, S, Hkv, Dh)
extern "C" int q3_decode_attention(const void* q, int q_bf16, const void* k,
                                   const void* v, int kv_bf16, const void* pos,
                                   int pos64, void* out, int B, int S, int Hq,
                                   int Hkv, int Dh, int scale_bits,
                                   void* stream) {
  const DaArgs a{q, q_bf16, k, v, pos, pos64, nullptr, 0, 0, out, S, Hq,
                 Hkv, Dh, 0, host_float(scale_bits), nullptr, nullptr};
  return (int)launch_attention(a, kv_bf16 ? DA_BF16 : DA_F32, B, false,
                               reinterpret_cast<cudaStream_t>(stream));
}

// K4: pool_k, pool_v (P, psz, Hkv, Dh), table (B, MAXP) int32 page ids
extern "C" int q3_paged_attention(const void* q, int q_bf16,
                                  const void* pool_k, const void* pool_v,
                                  int kv_bf16, const int* table,
                                  const void* pos, int pos64, void* out,
                                  int B, int MAXP, int psz, int Hq, int Hkv,
                                  int Dh, int scale_bits, void* stream) {
  if (MAXP < 1 || psz < 1 || (long long)MAXP * psz > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  const DaArgs a{q, q_bf16, pool_k, pool_v, pos, pos64, table, MAXP, psz,
                 out, MAXP * psz, Hq, Hkv, Dh, 0, host_float(scale_bits),
                 nullptr, nullptr};
  return (int)launch_attention(a, kv_bf16 ? DA_BF16 : DA_F32, B, true,
                               reinterpret_cast<cudaStream_t>(stream));
}

// K6: kq, vq the int8 cache (B, Hkv, S, Dh), ks, vs its f32 row scales
// (B, Hkv, S)
extern "C" int q3_decode_attention_kv_int8(
    const void* q, int q_bf16, const void* kq, const void* ks, const void* vq,
    const void* vs, const void* pos, int pos64, void* out, int B, int S,
    int Hq, int Hkv, int Dh, int scale_bits, void* stream) {
  const DaArgs a{q, q_bf16, kq, vq, pos, pos64, nullptr, 0, 0, out, S, Hq,
                 Hkv, Dh, 0, host_float(scale_bits),
                 reinterpret_cast<const float*>(ks),
                 reinterpret_cast<const float*>(vs)};
  return (int)launch_attention(a, DA_I8, B, false,
                               reinterpret_cast<cudaStream_t>(stream));
}
