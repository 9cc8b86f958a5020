// K1: weight-only int8 matmul, out (M, N) f32 = bf16(x) (M, K) @ bf16(q)
// (K, N) int8, f32 accumulate, x per-column f32 scale.
//
// Replaces the TPU kernel qwen3_tts_tpu/ops/pallas/qmatmul.py ::
// qmatmul_pallas.
//
// Bound on an H100: at the decode shapes (M <= 8) the kernel does 2 flops
// per weight byte, far below the ~295 flops/byte where the tensor cores
// would be the limit, so it is bound by streaming the K*N int8 weight
// bytes from HBM (3.35 TB/s peak). Two routes, chosen by shape in
// ops/kernels/qmatmul.py, both in the summation order of common.cuh (so
// their plain version is one, ops/kernels/common.qmm):
// - decode rows (1 <= M <= 8, every N a multiple of 16): q3_qmatmul_split,
//   the cluster-split qsplit product of K2 and K3 (common.cuh): 64-column
//   tiles, the k-slices of a tile split over a cluster of 2-8 blocks sized
//   so that >= 128 blocks are in flight, each block's weight rows copied
//   into shared memory by 16-byte cp.async before it waits for the
//   previous kernel (programmatic dependent launch), and up to three
//   weights that share x (q|k|v, gate|up) in one launch;
// - any other shape (prefill rows): q3_qmatmul, the qmm tile of 8 rows x
//   32 columns, each weight byte read once per row tile, the 4 lanes of a
//   weight row reading one 32-byte sector, up to 8 weight rows in flight a
//   thread. It re-reads the weights per row tile: a tensor-core tile for
//   prefill rows is later work.
#include "common.cuh"

// the qmm tile: any M
extern "C" int q3_qmatmul(const void* x, int x_bf16, const void* q,
                          const void* scale, void* out, int M, int K, int N,
                          void* stream) {
  QmmArgs a = {};
  a.x = x; a.x_bf16 = x_bf16; a.ldx = K;
  a.w = q; a.scale = reinterpret_cast<const float*>(scale);
  a.out = out; a.ldo = N;
  a.R = M; a.K = K; a.N = N; a.ldw = N;
  return (int)launch_qmm<PRO_PLAIN, int8_t, EPI_STORE_F32>(
      a, reinterpret_cast<cudaStream_t>(stream));
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
