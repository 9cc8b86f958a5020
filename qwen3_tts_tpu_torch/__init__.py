"""PyTorch port of the Qwen3-TTS framework for one NVIDIA H100: the
talker, code predictor and FP32 vocoder of qwen3_tts_tpu (the JAX
package, which stays the reference), with hand-written CUDA kernels for
the int8 decode path (csrc/, ops/kernels/)."""
