"""Command line: synthesize one text to a WAV file with the PyTorch port.

    python -m qwen3_tts_tpu_torch.cli "text" --output out.wav --seed 0 \
        [--quantize none|int8] [--streaming] [--device cuda]

Random weights (no checkpoint loading yet); bf16 unless ``--quantize
int8``, as the JAX package's CLI. ``--streaming`` synthesizes in
streaming mode (the engine's head chunks and the incremental vocoder
stream). Prints the per-stage
timings, the time to first audio and the real-time factor."""

from __future__ import annotations

import argparse

from qwen3_tts_tpu_torch.config import SUPPORTED_LANGUAGES


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("text")
    ap.add_argument("--output", default="output.wav")
    ap.add_argument("--language", default="russian",
                    choices=SUPPORTED_LANGUAGES)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max_tokens", type=int, default=None)
    ap.add_argument("--quantize", choices=("none", "int8"), default="none")
    ap.add_argument("--streaming", action="store_true",
                    help="streaming synthesis: audio in chunks as it is "
                         "decoded")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)

    from qwen3_tts_tpu_torch.engine.engine import TTSEngine

    eng = TTSEngine(quantize=None if args.quantize == "none" else "int8",
                    seed=args.seed, device=args.device)
    res = eng.synthesize(args.text, language=args.language,
                         output=args.output, seed=args.seed,
                         max_tokens=args.max_tokens,
                         streaming=args.streaming)
    stages = ", ".join(f"{k}={v * 1000:.1f}ms" for k, v in res.timings.items())
    print(f"{res.n_tokens} tokens, {res.audio_seconds:.2f} s audio -> "
          f"{args.output} | {stages} | total={res.total_seconds:.3f}s "
          f"RTF={res.rtf:.4f} ({eng.device})")
    if res.first_audio_seconds is not None:
        print(f"First audio: {res.first_audio_seconds:.3f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
