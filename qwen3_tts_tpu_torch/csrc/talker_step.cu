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
// softmax are f32 and p is rounded to bf16 after it is normalised, before
// P.V. Output: h (B, H) through bf16 (pre-final-norm) and the fresh K/V
// rows (L, 2, B, nKV, Dh) in f32, which the caller scatters into the
// cache.
//
// Bound on an H100: at B <= 8 a step streams the int8 weights once
// (28 layers x 15.7 MB at the 0.6B geometry, 440 MB) plus the KV read
// (at most 512 rows x 8 heads x 128 x 2 x 2 bytes per layer, bf16), at
// ~2 flops per weight byte: bound by HBM bandwidth, not by the tensor
// cores. Each layer is a fixed sequence of five launches, all under
// programmatic dependent launch (common.cuh), so each kernel's constant
// loads overlap the kernel before it:
// - the four products (q|k|v, o, gate|up, down) are one qsplit launch each
//   (common.cuh): 64-column tiles with their k-slice groups split over a
//   cluster of 2 (q|k|v, gate|up: 128 and 192 blocks) or 8 blocks (o,
//   down: 128), weights copied by 16-byte cp.async before the wait; they
//   keep the summation order stated once in common.cuh, so the plain
//   version's products (ops/kernels/common.qmm) did not change;
// - the attention is one cluster of TA_NSPLIT = 8 blocks per (kv head,
//   row), grid (8, nKV, B): 64 blocks at B = 1. Block c takes the chunk of
//   positions [c C, c C + C), C = ceil(S / 8) (a function of S only, so a
//   CUDA graph can capture the call), and copies its K and V rows <= pos
//   into shared memory by 16-byte cp.async before the wait: the cache is
//   constant during the step, so the K/V stream overlaps the q|k|v
//   product. A block computes the G query heads of its kv head.
//
// The attention's order (ops/kernels/talker_step.split_attention follows
// it, so the two agree bit for bit):
//   prologue  q (the block's G heads) and, in the block whose chunk holds
//             pos, the fresh k: f32 RMS over Dh (squares rounded, 32-lane
//             warp trees, the trees added in order from 0: what a block of
//             ATT_THREADS threads computes, the extra warps adding zeros),
//             then RoPE; q and k rounded to bf16;
//   score     s = row_dot(q, bf16 K) * scale (Dh / 8 lanes a row, each an
//             fma chain over 8 contiguous elements, an xor butterfly);
//   M         the max over s <= pos: the chunk maxima, exchanged through
//             distributed shared memory, every rank takes their max;
//   e         expf(s - M); the chunk sum l_c in lane_sum order (lane j
//             adds positions j, j + 32, ... of the chunk, then a warp
//             tree); every rank adds the live chunks' l_c in chunk order;
//   p         bf16(e / sum), as the TPU kernel rounds it;
//   P.V       per chunk, one fma chain per output in position order over
//             bf16 V; the rank that owns an output adds the live chunks'
//             partials in chunk order (from 0) and stores it as bf16.
// Three cluster barriers (after the maxima, the sums and the partials),
// no global scratch.
//
// K7 is the same step, through the same entry point, over the merged
// weight streams of tools/dev/microbench_talker_merged.py: per layer one
// int8 block [qkv | gate|up] (H, QKVD + 2I) and one [o ; down] (QD + I, H),
// and optionally one f32 block of the eight per-layer vectors. It replaces
// the TPU kernel at tools/dev/microbench_talker_merged.py:307 (merged_step;
// body _build_merged_kernel). The layer loop is K3's: only the weight
// pointers, their row strides (qsplit's ldw) and the scale and norm
// pointers differ, so K7 is bit-equal to K3 on the same weights. Times and
// the per-kernel breakdown: PERF.md
// (qwen3_tts_tpu_torch/tools/bench_talker_step).
#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int TA_NSPLIT = 8;     // blocks (chunks) per (kv head, row): a cluster
constexpr int TA_THREADS = 128;
constexpr int TA_WARPS = TA_THREADS / 32;
constexpr int TA_MAXG = 8;       // query heads per kv head
constexpr int TA_MAXDH = 128;    // a thread per output dimension
constexpr int TA_VEC = 8;        // elements of a lane's score chain
constexpr int TA_NBUF = 4;       // staging buffers (K tiles, then V tiles)
constexpr int TA_TILE_BYTES = 16 * 1024;  // bytes of K or V rows a buffer
constexpr int TA_MAX_SMEM = 200 * 1024;

// 8 contiguous staged K/V elements as f32, read as bf16 (f32 caches are
// rounded, as the TPU kernel reads its cache)
__device__ __forceinline__ void ld8kv(const __nv_bfloat16* p, float v[8]) {
  load8<__nv_bfloat16>(p, 0, v);
}

__device__ __forceinline__ void ld8kv(const float* p, float v[8]) {
  load8<float>(p, 0, v);
}

__device__ __forceinline__ float ldkv(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ float ldkv(const float* p) { return bf16r(*p); }

template <typename KV>
__device__ __forceinline__ KV to_kv(float v);

template <>
__device__ __forceinline__ __nv_bfloat16 to_kv<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <>
__device__ __forceinline__ float to_kv<float>(float v) {
  return bf16r(v);
}

struct TaArgs {
  const float* qkv;              // (B, QD + 2 KVD) f32: the q|k|v product
  const void* qn; const void* kn; int nw_bf16;  // (Dh,) norm weights
  const float* cos_t; const float* sin_t;       // (>= S, Dh)
  const int* pos;                // (B,)
  const void* k; const void* v;  // the layer's K and V, (B, S, nKV, Dh)
  __nv_bfloat16* attn;           // (B, QD)
  float* rows;                   // the layer's fresh rows (2, B, nKV, Dh)
  int B, S, nH, nKV, Dh;
  int tile;                      // rows a staging buffer holds
  float eps, scale;
};

// shared memory floats after the staging ring and the fresh K/V rows: the
// q and k rows (f32, then roped), their RMS scales, the block's scores,
// every rank's chunk maxima and sums, and the partials this rank adds up
__host__ __device__ inline int ta_floats(int G, int Dh, int C) {
  const int per = (G * Dh + TA_NSPLIT - 1) / TA_NSPLIT;
  return 2 * (G + 1) * Dh + (G + 1) + G * C + 2 * TA_NSPLIT * G +
         TA_NSPLIT * per;
}

// GM: query heads held in registers (2 for the talker's G, else 8)
template <typename KV, int GM>
__global__ void __launch_bounds__(TA_THREADS)
talker_attn_kernel(TaArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();
  const int S = a.S, Dh = a.Dh, nKV = a.nKV;
  const int G = a.nH / nKV, GD = G * Dh;
  const int QD = a.nH * Dh, KVD = nKV * Dh, ld = QD + 2 * KVD;
  const int C = (S + TA_NSPLIT - 1) / TA_NSPLIT, tile = a.tile;
  const int c = (int)cluster.block_rank(), h = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int p = min(max(a.pos[b], 0), S - 1);
  const int c0 = c * C;
  const int n = max(0, min(C, p + 1 - c0));  // the block's positions <= p
  const int nc = p / C + 1;                  // live chunks
  const bool owner = c == p / C;             // holds pos: the fresh row
  const int per = (GD + TA_NSPLIT - 1) / TA_NSPLIT;

  // shared: ring[nbuf][tile * Dh] (KV) | krow, vrow [Dh] (KV) | xq[(G+1)
  // Dh] | xr[(G+1) Dh] | inv[G+1] | sc[G][C] | rmax[8][G] | rsum[8][G] |
  // ro[8][per]
  const int nt = (n + tile - 1) / tile, nst = 2 * nt;  // K tiles, then V
  const int ntmax = (C + tile - 1) / tile;
  const int nbuf = min(TA_NBUF, 2 * ntmax);
  KV* ring = reinterpret_cast<KV*>(smem);
  KV* krow = ring + (size_t)nbuf * tile * Dh;
  KV* vrow = krow + Dh;
  float* xq = reinterpret_cast<float*>(
      smem + qs_align16(((size_t)nbuf * tile + 2) * Dh * sizeof(KV)));
  float* xr = xq + (G + 1) * Dh;
  float* inv = xr + (G + 1) * Dh;
  float* sc = inv + (G + 1);
  float* rmax = sc + G * C;
  float* rsum = rmax + TA_NSPLIT * G;
  float* ro = rsum + TA_NSPLIT * G;

  // 1. the block's K and V rows <= p, before the previous kernel is
  // waited for (the cache is constant during the step): one commit group
  // a stage, TA_NBUF stages in flight, so stage st is group st (a ring of
  // nbuf < TA_NBUF buffers holds every stage: nst <= nbuf)
  const long base = ((long)b * S + c0) * KVD + (long)h * Dh;
  const int ppr = Dh * (int)sizeof(KV) / 16;  // 16-byte pieces a row
  auto copy_stage = [&](int st) {
    const bool is_v = st >= nt;
    const int r0 = (is_v ? st - nt : st) * tile, rows = min(tile, n - r0);
    const KV* src = reinterpret_cast<const KV*>(is_v ? a.v : a.k) + base +
                    (long)r0 * KVD;
    KV* dst = ring + (st % nbuf) * tile * Dh;
    for (int i = t; i < rows * ppr; i += TA_THREADS) {
      const int r = i / ppr, j = i - r * ppr;
      cp_async16(reinterpret_cast<char*>(dst + r * Dh) + 16 * j,
                 reinterpret_cast<const char*>(src + r * KVD) + 16 * j);
    }
  };
#pragma unroll
  for (int st = 0; st < TA_NBUF; ++st) {
    if (st < nst && st < nbuf) copy_stage(st);
    cp_async_commit();
  }
  grid_dep_wait();    // q|k|v are written
  grid_dep_launch();  // the o product may start its weight copies

  // 2. prologue: q of the G heads (and, in the owner, the fresh k and v)
  // from the q|k|v product; RMS over Dh, one warp a head; RoPE at p
  const int nh = G + (owner ? 1 : 0);  // rows of xq: q heads, then k
  float vnew = 0.f;
  if (n > 0) {
    const float* qkv = a.qkv + (long)b * ld;
    for (int i = t; i < nh * Dh; i += TA_THREADS)
      xq[i] = i < GD ? qkv[(long)h * GD + i] : qkv[QD + h * Dh + i - GD];
    if (owner && t < Dh) vnew = qkv[QD + KVD + h * Dh + t];
    __syncthreads();
    for (int j = warp; j < nh; j += TA_WARPS) {
      float tot = 0.f;
      for (int s0 = 0; s0 < Dh; s0 += 32) {
        const float x = s0 + lane < Dh ? xq[j * Dh + s0 + lane] : 0.f;
        tot += __shfl_sync(0xffffffffu, warp_sum(__fmul_rn(x, x)), 0);
      }
      if (lane == 0) inv[j] = rms_scale(tot, Dh, a.eps);
    }
    __syncthreads();
    for (int i = t; i < nh * Dh; i += TA_THREADS) {
      const int j = i / Dh;
      xq[i] = rms_apply(xq[i], inv[j],
                        ldf(j < G ? a.qn : a.kn, i - j * Dh, a.nw_bf16));
    }
    __syncthreads();
    for (int i = t; i < nh * Dh; i += TA_THREADS) {
      const int j = i / Dh, d = i - j * Dh;
      const float r = rope_at(xq + j * Dh, d, Dh, a.cos_t[(long)p * Dh + d],
                              a.sin_t[(long)p * Dh + d]);
      xr[i] = j < G ? bf16r(r) : r;
    }
    __syncthreads();
    if (owner && t < Dh) {
      const float knew = xr[GD + t];
      krow[t] = to_kv<KV>(knew);
      vrow[t] = to_kv<KV>(vnew);
      float* rows = a.rows + ((long)b * nKV + h) * Dh + t;
      rows[0] = knew;                      // rows[0, b, h, t]
      rows[(long)a.B * KVD] = vnew;        // rows[1, b, h, t]
    }
  }

  // 3. scores of the block's positions: lane gl of row group grp holds
  // q[g, 8 gl .. 8 gl + 7] of every head g
  const int lpr = Dh / TA_VEC, ngrp = 32 / lpr;
  const int grp = lane / lpr, gl = lane - grp * lpr;
  float qr[GM][TA_VEC];
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int j = 0; j < TA_VEC; ++j)
      qr[g][j] = g < G && n > 0 ? xr[g * Dh + gl * TA_VEC + j] : 0.f;
  for (int st = 0; st < nt; ++st) {
    cp_async_wait<TA_NBUF - 1>();  // stage st has landed
    __syncthreads();
    const KV* buf = ring + (st % nbuf) * tile * Dh;
    const int r0 = st * tile, rows = min(tile, n - r0);
    // the trip count is uniform over the warp: every shuffle has all lanes
    for (int rb = warp * ngrp; rb < rows; rb += TA_WARPS * ngrp) {
      const int r = min(rb + grp, rows - 1);  // rows past the tile repeat
      const KV* src = c0 + r0 + r == p ? krow : buf + r * Dh;
      float kv8[TA_VEC], d[GM];
      ld8kv(src + gl * TA_VEC, kv8);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        d[g] = 0.f;
#pragma unroll
        for (int j = 0; j < TA_VEC; ++j) d[g] = fmaf(qr[g][j], kv8[j], d[g]);
      }
      for (int o = lpr >> 1; o > 0; o >>= 1)
#pragma unroll
        for (int g = 0; g < GM; ++g)
          d[g] += __shfl_xor_sync(0xffffffffu, d[g], o);
      if (gl == 0 && rb + grp < rows)
#pragma unroll
        for (int g = 0; g < GM; ++g)
          if (g < G) sc[g * C + r0 + r] = __fmul_rn(d[g], a.scale);
    }
    __syncthreads();  // buffer st % nbuf consumed
    if (st + nbuf < nst) copy_stage(st + nbuf);
    cp_async_commit();
  }

  // 4. the chunk maxima to every rank; M
  cluster_wait();  // every block of the cluster has started
  for (int g = warp; g < G && n > 0; g += TA_WARPS) {
    float m = -INFINITY;
    for (int r = lane; r < n; r += 32) m = fmaxf(m, sc[g * C + r]);
    m = warp_max(m);
    if (lane < nc) cluster.map_shared_rank(rmax, lane)[c * G + g] = m;
  }
  cluster_arrive();
  cluster_wait();

  // 5. e = expf(s - M) and the chunk sums to every rank; the total
  for (int g = warp; g < G && n > 0; g += TA_WARPS) {
    float M = -INFINITY;
    for (int r = 0; r < nc; ++r) M = fmaxf(M, rmax[r * G + g]);
    float tot = 0.f;
    for (int r = lane; r < n; r += 32) {
      const float e = expf(sc[g * C + r] - M);
      sc[g * C + r] = e;
      tot += e;
    }
    tot = __shfl_sync(0xffffffffu, warp_sum(tot), 0);
    if (lane < nc) cluster.map_shared_rank(rsum, lane)[c * G + g] = tot;
  }
  cluster_arrive();
  cluster_wait();

  // 6. p = bf16(e / sum), then P.V over the V tiles: thread d runs the
  // chains of output d of every head in position order
  for (int i = t; i < G * n && n > 0; i += TA_THREADS) {
    const int g = i / n, r = i - g * n;
    float tot = 0.f;
    for (int cc = 0; cc < nc; ++cc) tot += rsum[cc * G + g];
    sc[g * C + r] = bf16r(__fdiv_rn(sc[g * C + r], tot));
  }
  float acc[GM];
#pragma unroll
  for (int g = 0; g < GM; ++g) acc[g] = 0.f;
  for (int st = nt; st < nst; ++st) {
    cp_async_wait<TA_NBUF - 1>();
    __syncthreads();  // the stage, and (first) every p, visible
    const KV* buf = ring + (st % nbuf) * tile * Dh;
    const int r0 = (st - nt) * tile, rows = min(tile, n - r0);
    if (t < Dh) {
#pragma unroll 4
      for (int r = 0; r < rows; ++r) {
        const float vv =
            ldkv(c0 + r0 + r == p ? vrow + t : buf + r * Dh + t);
#pragma unroll
        for (int g = 0; g < GM; ++g)
          if (g < G) acc[g] = fmaf(sc[g * C + r0 + r], vv, acc[g]);
      }
    }
    __syncthreads();
    if (st + nbuf < nst) copy_stage(st + nbuf);
    cp_async_commit();
  }
  // each output's partial to the rank that adds it up
  if (n > 0 && t < Dh) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < G) {
        const int o = g * Dh + t, r = o / per;
        cluster.map_shared_rank(ro, r)[c * per + o - r * per] = acc[g];
      }
    }
  }
  cluster_arrive();
  cluster_wait();

  // 7. this rank's outputs: the live chunks' partials in chunk order
  for (int i = t; i < per && c * per + i < GD; i += TA_THREADS) {
    float sum = 0.f;
    for (int cc = 0; cc < nc; ++cc) sum += ro[cc * per + i];
    a.attn[(long)b * QD + (long)h * GD + c * per + i] =
        __float2bfloat16_rn(sum);
  }
}

template <typename KV, int GM>
cudaError_t launch_attn(const TaArgs& a, size_t smem, cudaStream_t st) {
  static std::atomic<unsigned> smem_set{0};  // one per instantiation
  const cudaError_t e =
      allow_smem(talker_attn_kernel<KV, GM>, TA_MAX_SMEM, smem_set);
  if (e != cudaSuccess) return e;
  return launch_pdl(talker_attn_kernel<KV, GM>,
                    dim3(TA_NSPLIT, a.nKV, a.B), dim3(TA_THREADS), smem, st,
                    TA_NSPLIT, a);
}

template <typename KV>
cudaError_t launch_attn_kv(const TaArgs& a, size_t smem, cudaStream_t st) {
  return a.nH <= 2 * a.nKV ? launch_attn<KV, 2>(a, smem, st)
                           : launch_attn<KV, TA_MAXG>(a, smem, st);
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

// layer l's block of m as a product segment into out (R, ldo)
void layer_seg(Product& p, const LMat& m, int l, void* out, int ldo, int N) {
  p.seg(m.q + (long)l * m.ls, (const float*)at(m.s, l, 4), out, ldo, N,
        m.ld);
}

int talker_layers(const TalkerWeights& w, const void* x, int x_bf16,
                  const int* pos, const float* cos_t,
                  const float* sin_t, const void* kv, int kv_bf16,
                  void* h_out, float* rows_out, float* hbuf, float* qkv_buf,
                  __nv_bfloat16* attn_buf, float* gu_buf, int L, int B,
                  int S, int H, int nH, int nKV, int Dh, int I, float eps,
                  float scale, cudaStream_t st) {
  const int lpr = Dh / TA_VEC;
  if (B < 1 || B > QS_MAXR || S < 1 || nKV < 1 || nH % nKV ||
      nH / nKV > TA_MAXG || Dh < TA_VEC || Dh > TA_MAXDH || Dh % TA_VEC ||
      (lpr & (lpr - 1)) || reinterpret_cast<uintptr_t>(kv) % 16)
    return (int)cudaErrorInvalidValue;
  const int G = nH / nKV, QD = nH * Dh, KVD = nKV * Dh, NQKV = QD + 2 * KVD;
  const long esz = w.nw_bf16 ? 2 : 4, kvsz = kv_bf16 ? 2 : 4;
  const long kv_layer = 2L * B * S * KVD;
  const int C = (S + TA_NSPLIT - 1) / TA_NSPLIT;
  const int fit = (int)(TA_TILE_BYTES / (Dh * kvsz));  // rows a buffer holds
  const int tile = C < fit ? C : fit;
  const int ntmax = (C + tile - 1) / tile;
  const int nbuf = TA_NBUF < 2 * ntmax ? TA_NBUF : 2 * ntmax;
  const size_t att_smem =
      qs_align16(((size_t)nbuf * tile + 2) * Dh * kvsz) +
      (size_t)ta_floats(G, Dh, C) * sizeof(float);
  if (att_smem > (size_t)TA_MAX_SMEM) return (int)cudaErrorInvalidValue;

  // h (f32) = bf16(x): the residual stream starts from the bf16 input
  Q3_TRY(launch_convert(x, x_bf16, hbuf, 0, 1, (long)B * H, st));
  for (int l = 0; l < L; ++l) {
    // qkv = qmm(bf16(rms(h, input_ln)), qkv)
    Product qkv(B, H, eps);
    qkv.rows(hbuf, 0, H).norm(at(w.input_ln, l, esz), w.nw_bf16);
    layer_seg(qkv, w.qkv, l, qkv_buf, NQKV, NQKV);
    Q3_TRY((launch_qsplit<PRO_RMS, int8_t, EPI_STORE_F32>(qkv.a, st)));

    const char* kvl = (const char*)kv + l * kv_layer * kvsz;
    const TaArgs ta{qkv_buf, at(w.q_norm, l, esz), at(w.k_norm, l, esz),
                    w.nw_bf16, cos_t, sin_t, pos, kvl,
                    kvl + (long)B * S * KVD * kvsz, attn_buf,
                    rows_out + l * 2L * B * KVD, B, S, nH, nKV, Dh, tile,
                    eps, scale};
    Q3_TRY(kv_bf16 ? launch_attn_kv<__nv_bfloat16>(ta, att_smem, st)
                   : launch_attn_kv<float>(ta, att_smem, st));

    // h += qmm(attn, o_proj)
    Product o(B, QD, eps);
    o.rows(attn_buf, 1, QD);
    layer_seg(o, w.o, l, hbuf, H, H);
    Q3_TRY((launch_qsplit<PRO_PLAIN, int8_t, EPI_ADD_F32>(o.a, st)));

    // gu = qmm(bf16(rms(h, post_ln)), gate|up)
    Product gu(B, H, eps);
    gu.rows(hbuf, 0, H).norm(at(w.post_ln, l, esz), w.nw_bf16);
    layer_seg(gu, w.gu, l, gu_buf, 2 * I, 2 * I);
    Q3_TRY((launch_qsplit<PRO_RMS, int8_t, EPI_STORE_F32>(gu.a, st)));

    // h += qmm(bf16(silu(g) * u), down)
    Product dn(B, I, eps);
    dn.rows(gu_buf, 0, 2 * I);
    layer_seg(dn, w.down, l, hbuf, H, H);
    Q3_TRY((launch_qsplit<PRO_SWIGLU, int8_t, EPI_ADD_F32>(dn.a, st)));
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
    const void* x, int x_bf16, const int* pos,
    const float* cos_t, const float* sin_t, const int8_t* qkv_q, long qkv_ls,
    int qkv_ld, const float* qkv_s, long qkv_sls, const int8_t* o_q,
    long o_ls, int o_ld, const float* o_s, long o_sls, const int8_t* gu_q,
    long gu_ls, int gu_ld, const float* gu_s, long gu_sls, const int8_t* d_q,
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
  return talker_layers(w, x, x_bf16, pos, cos_t, sin_t, kv, kv_bf16,
                       h_out, rows_out, hbuf, qkv_buf, attn_buf, gu_buf, L,
                       B, S, H, nH, nKV, Dh, I, host_float(eps_bits),
                       host_float(scale_bits),
                       reinterpret_cast<cudaStream_t>(stream));
}
