"""Command line: synthesize one text to a WAV file with the PyTorch port.

    python -m qwen3_tts_tpu_torch.cli "text" --output out.wav --seed 0 \
        [--model_dir DIR] [--quantize none|int8|int8-cp] [--streaming] \
        [--long] [--prompt_dir DIR] [--profile DIR] [--tiny] [--device cuda]

The flags of the JAX package's CLI (qwen3_tts_tpu/cli.py) but ``--tp``,
with ``--device`` for its ``--platform``; bf16 unless ``--dtype
float32``. ``--model_dir`` loads a checkpoint (a ``params.npz`` of either
package, or an HF directory with ``model.safetensors``) and its geometry;
without it the weights are random from ``--seed``. ``--streaming``
synthesizes in streaming mode (the engine's head chunks and the
incremental vocoder stream); ``--long`` splits a paragraph into sentence
pieces (TTSEngine.synthesize_long); ``--prompt_dir`` clones the voice of
a prompt dir (ref_codec_tokens.npy and ref_text.txt); ``--profile DIR``
writes a torch.profiler trace of the call into DIR. Prints the per-stage
timings, the time to first audio and the real-time factor. Returns 1 on
a request error (``error: ...`` on stderr) and when no token was
generated."""

from __future__ import annotations

import argparse
import dataclasses
import sys

from qwen3_tts_tpu_torch.config import SUPPORTED_LANGUAGES

DEFAULT_TEXT = "Привет, как дела? Сегодня хорошая погода для прогулки."


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("text", nargs="?", default=None)
    ap.add_argument("--text", dest="text_flag", default=None)
    ap.add_argument("--output", default="output.wav")
    ap.add_argument("--language", default="russian",
                    choices=SUPPORTED_LANGUAGES)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max_tokens", type=int, default=None,
                    help="the config's token cap (and so --long's piece "
                         "budget)")
    ap.add_argument("--temperature", type=float, default=None)
    ap.add_argument("--top_k", type=int, default=None)
    ap.add_argument("--tiny", action="store_true",
                    help="tiny geometry (tests on the CPU)")
    ap.add_argument("--quantize", choices=("none", "int8", "int8-cp"),
                    default="none",
                    help="weight-only int8 for the talker and the code "
                         "predictor (int8) or the code predictor alone "
                         "(int8-cp)")
    ap.add_argument("--streaming", action="store_true",
                    help="streaming synthesis: audio in chunks as it is "
                         "decoded")
    ap.add_argument("--long", action="store_true",
                    help="paragraph mode: split the text into sentence "
                         "pieces decoded in batched groups "
                         "(synthesize_long)")
    ap.add_argument("--prompt_dir", default=None,
                    help="voice-cloning prompt dir (ref_codec_tokens.npy "
                         "and ref_text.txt)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the call to DIR")
    ap.add_argument("--model_dir", default=None,
                    help="checkpoint dir (params.npz, or model.safetensors "
                         "and speech_tokenizer/); random weights if "
                         "omitted")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    text = args.text or args.text_flag or DEFAULT_TEXT

    import os

    import torch

    from qwen3_tts_tpu_torch.config import TTSConfig, tiny_tts_config
    from qwen3_tts_tpu_torch.engine import engine as tengine
    from qwen3_tts_tpu_torch.io import weights as weights_io
    from qwen3_tts_tpu_torch.utils.profiling import device_trace

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    preloaded = None
    if args.tiny:
        cfg = tiny_tts_config(max_tokens=32)
    elif args.model_dir:
        # the geometry from the checkpoint, in load_params' order; a
        # params.npz is loaded here once and handed to the engine
        npz = os.path.join(args.model_dir, "params.npz")
        if os.path.exists(npz):
            cfg = weights_io.read_npz_config(npz)
            preloaded = weights_io.load_params(args.model_dir, TTSConfig(),
                                               dtype, args.seed, args.device)
            if cfg is None:
                cfg = weights_io.config_from_params(preloaded)
        elif os.path.exists(os.path.join(args.model_dir,
                                         "model.safetensors")):
            cfg = weights_io.detect_tts_config(args.model_dir)
        else:
            cfg = TTSConfig()
    else:
        cfg = TTSConfig()
    if args.max_tokens is not None:
        cfg = dataclasses.replace(cfg, max_tokens=args.max_tokens)
    sampling = cfg.sampling
    if args.temperature is not None:
        sampling = dataclasses.replace(sampling, temperature=args.temperature)
    if args.top_k is not None:
        sampling = dataclasses.replace(sampling, top_k=args.top_k)
    cfg = dataclasses.replace(cfg, sampling=sampling)

    print(f"Text: '{text}'")
    print(f"Language: {args.language}")
    eng = tengine.TTSEngine(
        cfg=cfg, model_dir=args.model_dir, seed=args.seed,
        device=args.device, dtype=dtype, params=preloaded,
        quantize=None if args.quantize == "none" else args.quantize)
    try:
        with device_trace(args.profile, eng.device):
            if args.long:
                if args.streaming:
                    print("note: --long emits audio per finished "
                          "sentence; --streaming's intra-sentence head "
                          "schedule does not apply")
                res = eng.synthesize_long(text, language=args.language,
                                          output=args.output, seed=args.seed,
                                          prompt_dir=args.prompt_dir)
            else:
                res = eng.synthesize(text, language=args.language,
                                     output=args.output, seed=args.seed,
                                     streaming=args.streaming,
                                     prompt_dir=args.prompt_dir)
    except ValueError as e:
        # a request the caller can fix (language, prompt dir, a cloned
        # text that overflows the prefix): a message, not a traceback
        print(f"error: {e}", file=sys.stderr)
        return 1
    if res.n_tokens == 0:
        print("No tokens generated!")
        return 1
    stages = ", ".join(f"{k}={v * 1000:.1f}ms" for k, v in res.timings.items())
    print(f"{res.n_tokens} tokens, {res.audio_seconds:.2f} s audio -> "
          f"{args.output} | {stages} | total={res.total_seconds:.3f}s "
          f"RTF={res.rtf:.4f} ({eng.device})")
    if res.first_audio_seconds is not None:
        print(f"First audio: {res.first_audio_seconds:.3f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
