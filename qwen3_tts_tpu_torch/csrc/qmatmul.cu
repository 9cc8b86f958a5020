// K1: weight-only int8 matmul, out (M, N) f32 = bf16(x) (M, K) @ bf16(q)
// (K, N) int8, f32 accumulate, x per-column f32 scale.
//
// Replaces the TPU kernel qwen3_tts_tpu/ops/pallas/qmatmul.py ::
// qmatmul_pallas.
//
// Bound on an H100: at the decode shapes (M <= 8) the kernel does 2 flops
// per weight byte, far below the ~295 flops/byte where the tensor cores
// would be the limit, so it is bound by streaming the K*N int8 weight
// bytes from HBM (3.35 TB/s peak). The design reads each weight byte
// exactly once per 8-row tile (int8 in HBM, converted to bf16 in
// registers, as on the TPU), with the 4 lanes of a weight row reading
// one full 32-byte sector, spreads the N/32 column tiles over the SMs, and
// keeps each thread's loads of up to 8 weight rows in flight at once.
// Prefill (M up to 265) tiles the rows by 8 and re-reads the weights per
// row tile: correct first; a tensor-core version is later work.
#include "common.cuh"

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

extern "C" const char* q3_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
