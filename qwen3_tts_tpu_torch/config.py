"""Geometry and sampling configuration of the port: the part of
qwen3_tts_tpu/config.py that synthesis, the batcher and the encoder
read, with the same fields, defaults and constants
(tests/test_torch_modules.py holds the two equal; a params.npz embeds
``dataclasses.asdict(TTSConfig)`` with the same keys in both). The
port keeps its own copy so that it imports nothing of the JAX package.

Qwen3-TTS-12Hz-0.6B-Base: a 28-layer Qwen3 talker, a 5-layer code
predictor with 15 per-group codec embeddings and lm_heads, and the FP32
decoder of the speech tokenizer v2 (16 codebooks, 1920x upsampling to
24 kHz) with its encoder (1920x downsampling, voice-cloning prep)."""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class TalkerConfig:
    num_layers: int = 28
    hidden_size: int = 1024
    intermediate_size: int = 3072
    num_heads: int = 16
    num_kv_heads: int = 8
    head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    text_vocab_size: int = 151936
    text_embed_dim: int = 2048
    codec_vocab_size: int = 3072
    max_seq_len: int = 512
    # "xla": decode attention in plain torch ops; "pallas": the
    # hand-written decode-attention kernel (K5, ops/kernels/
    # decode_attention.py), the port of the JAX package's Pallas kernel
    attention_impl: str = "xla"


@dataclasses.dataclass(frozen=True)
class CodePredictorConfig:
    num_layers: int = 5
    hidden_size: int = 1024
    intermediate_size: int = 3072
    num_heads: int = 16
    num_kv_heads: int = 8
    head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    num_groups: int = 15          # groups 1..15 predicted per talker token
    group_vocab_size: int = 2048  # per-group codec vocab
    max_seq_len: int = 16         # 2 prefill + 14 decode positions
    attention_impl: str = "xla"


@dataclasses.dataclass(frozen=True)
class VocoderConfig:
    """FP32 codec decoder: a sliding-window pre-transformer, ConvNeXt
    upsampling stages, then SnakeBeta decoder blocks; prod(upsample_rates)
    * prod(upsampling_ratios) = 1920 samples per token."""

    num_codebooks: int = 16
    codebook_size: int = 2048
    hidden_size: int = 1024
    num_hidden_layers: int = 8
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    intermediate_size: int = 3072
    sliding_window: int = 72
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    layer_scale_initial_scale: float = 0.01
    upsampling_ratios: Tuple[int, ...] = (2, 2)
    decoder_dim: int = 1536
    upsample_rates: Tuple[int, ...] = (8, 5, 4, 3)
    sample_rate: int = 24000

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def total_upsample(self) -> int:
        out = 1
        for r in self.upsample_rates + self.upsampling_ratios:
            out *= r
        return out

    @property
    def output_crop(self) -> int:
        """Samples the causal transposed convs crop from the tail of a
        full decode: out_len(T) = T * total_upsample - output_crop. Each
        decoder block's ConvTranspose(k=2r, s=r) loses r frames at its
        own resolution."""
        loss = 0
        for r in self.upsample_rates:
            loss = loss * r + r
        return loss


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Speech-tokenizer encoder (voice-cloning prep): the decoder's block
    plan in reverse. Strided causal convs with residual units at dilation
    (1, 3, 9) and channel doubling, ConvNeXt downsampling stages, a
    sliding-window transformer, then 16-stage residual VQ against the
    decoder's codebooks (models/encoder.py). Tensor names mirror the
    decoder's under ``encoder.*``."""

    num_codebooks: int = 16
    codebook_size: int = 2048
    hidden_size: int = 1024
    num_hidden_layers: int = 8
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    intermediate_size: int = 3072
    sliding_window: int = 72
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    layer_scale_initial_scale: float = 0.01
    decoder_dim: int = 1536  # mirrored channel plan
    # downsample rates applied in order (the decoder's upsampling reversed)
    downsample_rates: Tuple[int, ...] = (3, 4, 5, 8)
    downsampling_ratios: Tuple[int, ...] = (2, 2)
    sample_rate: int = 24000

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def total_downsample(self) -> int:
        out = 1
        for r in self.downsample_rates + self.downsampling_ratios:
            out *= r
        return out


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """code_0 sampling policy and the code predictor's group sampling."""

    temperature: float = 0.8
    top_k: int = 50
    top_p: float = 0.95
    repetition_penalty: float = 1.2
    repetition_window: int = 30
    eos_boost_start: float = 0.8   # progress threshold
    eos_boost_ramp: float = 0.7    # ramp width
    eos_boost_max: float = 15.0
    eos_force_progress: float = 2.0
    expected_tokens_per_text_token: int = 3
    cp_temperature: float = 0.1
    cp_top_k: int = 50


# special codec token ids
CODEC_PAD_ID = 2148
CODEC_BOS_ID = 2149
CODEC_EOS_ID = 2150
CODEC_NOTHINK_ID = 2155
CODEC_THINK_BOS_ID = 2156
CODEC_THINK_EOS_ID = 2157
NUM_AUDIO_CODES = 2048  # valid audio codes are 0..2047

# special text-vocab ids
TTS_PAD_TOKEN_ID = 151671
TTS_BOS_TOKEN_ID = 151672
TTS_EOS_TOKEN_ID = 151673
IM_START_TOKEN_ID = 151644
ASSISTANT_TOKEN_ID = 77091
NEWLINE_TOKEN_ID = 198

SAMPLE_RATE = 24000
SAMPLES_PER_TOKEN = 1920
VOC_CHUNK_SIZE = 64    # tokens a chunk of synthesize_exact past one window
VOC_OVERLAP = 16       # crossfade tokens of synthesize_chunked

# accepted for API compatibility; the language does not change the prefix
SUPPORTED_LANGUAGES = (
    "chinese", "english", "german", "russian", "french", "japanese", "korean",
)


@dataclasses.dataclass(frozen=True)
class TTSConfig:
    talker: TalkerConfig = TalkerConfig()
    code_predictor: CodePredictorConfig = CodePredictorConfig()
    vocoder: VocoderConfig = VocoderConfig()
    encoder: EncoderConfig = EncoderConfig()
    sampling: SamplingConfig = SamplingConfig()
    max_tokens: int = 200


def tiny_tts_config(max_tokens: int = 16) -> TTSConfig:
    """A miniature geometry for CPU tests: same structure, small dims."""
    talker = TalkerConfig(
        num_layers=2, hidden_size=64, intermediate_size=128,
        num_heads=4, num_kv_heads=2, head_dim=16,
        text_vocab_size=151936, text_embed_dim=32,
        codec_vocab_size=3072, max_seq_len=128,
    )
    cp = CodePredictorConfig(
        num_layers=2, hidden_size=64, intermediate_size=128,
        num_heads=4, num_kv_heads=2, head_dim=16,
        num_groups=15, group_vocab_size=2048,
    )
    voc = VocoderConfig(
        num_codebooks=16, codebook_size=2048,
        hidden_size=16, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=4,
        intermediate_size=32, sliding_window=8,
        decoder_dim=32,
    )
    enc = EncoderConfig(
        num_codebooks=16, codebook_size=2048,
        hidden_size=16, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=4,
        intermediate_size=32, sliding_window=8,
        decoder_dim=32,
    )
    return TTSConfig(talker=talker, code_predictor=cp, vocoder=voc,
                     encoder=enc, max_tokens=max_tokens)
