"""Command line: synthesize one text to a WAV file with the PyTorch port.

    python -m qwen3_tts_tpu_torch.cli "text" --output out.wav --seed 0 \
        [--model_dir DIR] [--quantize none|int8|int8-cp] [--streaming] \
        [--long] [--prompt_dir DIR] [--profile DIR] [--tiny] [--device cuda] \
        [--tp N]

The flags of the JAX package's CLI (qwen3_tts_tpu/cli.py), with
``--device`` for its ``--platform``; bf16 unless ``--dtype float32``.
``--tp N`` shards the engine over N ranks (parallel/mesh.py): the command
starts them itself, rank r on ``cuda:r`` (``cpu`` with ``--device cpu``),
and rank 0 prints and writes the WAV. ``--model_dir`` loads a
checkpoint (a ``params.npz`` of either package, or an HF directory with
``model.safetensors``) and its geometry; without it the weights are
random from ``--seed``. ``--streaming``
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
import os
import sys

from qwen3_tts_tpu_torch.config import SUPPORTED_LANGUAGES

DEFAULT_TEXT = "Привет, как дела? Сегодня хорошая погода для прогулки."
# --tp N: the ranks' run is ended past this (a hung rank would otherwise
# hold its peers until their collectives time out)
RANK_TIMEOUT_S = 3600.0


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
    ap.add_argument("--tp", type=int, default=0, metavar="N",
                    help="tensor parallelism over N ranks, one a device "
                         "(weights column/row-parallel, KV over kv heads; "
                         "parallel/mesh.py), started by this command. Not "
                         "with --quantize int8 (the fused int8 talker "
                         "layout is single-device; int8-cp shards). 0 "
                         "(default): no mesh; 1: a one-rank mesh. The ranks "
                         "are ended after an hour")
    return ap


def _run_ranks(n: int, argv) -> int:
    """Start the N ranks of ``--tp N`` (this command again, through
    multihost.run_own_ranks) and wait for them, at most RANK_TIMEOUT_S
    seconds. Returns the failing rank's exit code, else 0."""
    from qwen3_tts_tpu_torch.parallel import multihost as mh
    return mh.run_own_ranks(
        "qwen3_tts_tpu_torch.cli",
        list(sys.argv[1:] if argv is None else argv), n, f"--tp {n}",
        timeout=RANK_TIMEOUT_S)


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    text = args.text or args.text_flag or DEFAULT_TEXT
    if args.tp > 0 and args.quantize == "int8":
        print("error: --tp requires --quantize int8-cp or none (the fused "
              "int8 talker layout is single-device)", file=sys.stderr)
        return 1

    import torch

    from qwen3_tts_tpu_torch.parallel import multihost as mh

    mesh, rank0 = None, True
    if args.tp > 0:
        try:
            if mh.init_distributed(
                    device="cpu" if args.device == "cpu" else None):
                mesh = mh.make_serving_mesh(tp=args.tp, dp=1)
                rank0 = mesh.rank == 0
            elif args.tp > 1:
                if args.device != "cpu":
                    # every rank needs a card of its own (the first N of
                    # this host's): fail here, not in N processes
                    cards = [f"cuda:{i}"
                             for i in range(torch.cuda.device_count())]
                    mh.make_serving_mesh(tp=args.tp, dp=1,
                                         devices=cards[:args.tp])
                return _run_ranks(args.tp, argv)
            else:
                mesh = mh.make_serving_mesh(tp=1, dp=1,
                                            devices=[args.device])
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            mh.shutdown_distributed()
            return 1
        if rank0:
            print(f"Mesh: tp={args.tp} over "
                  f"{[d.device for d in mesh.devices.flat]}")
    try:
        return _synthesize(args, text, mesh, rank0)
    finally:
        mh.shutdown_distributed()


def _synthesize(args, text: str, mesh, rank0: bool) -> int:
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

    say = print if rank0 else (lambda *a, **k: None)
    output = args.output if rank0 else None
    say(f"Text: '{text}'")
    say(f"Language: {args.language}")
    eng = tengine.TTSEngine(
        cfg=cfg, model_dir=args.model_dir, seed=args.seed,
        device=args.device, dtype=dtype, params=preloaded,
        quantize=None if args.quantize == "none" else args.quantize,
        mesh=mesh)
    try:
        with device_trace(args.profile if rank0 else None, eng.device):
            if args.long:
                if args.streaming:
                    say("note: --long emits audio per finished "
                        "sentence; --streaming's intra-sentence head "
                        "schedule does not apply")
                res = eng.synthesize_long(text, language=args.language,
                                          output=output, seed=args.seed,
                                          prompt_dir=args.prompt_dir)
            else:
                res = eng.synthesize(text, language=args.language,
                                     output=output, seed=args.seed,
                                     streaming=args.streaming,
                                     prompt_dir=args.prompt_dir)
    except ValueError as e:
        # a request the caller can fix (language, prompt dir, a cloned
        # text that overflows the prefix): a message, not a traceback
        print(f"error: {e}", file=sys.stderr)
        return 1
    if res.n_tokens == 0:
        say("No tokens generated!")
        return 1
    stages = ", ".join(f"{k}={v * 1000:.1f}ms" for k, v in res.timings.items())
    say(f"{res.n_tokens} tokens, {res.audio_seconds:.2f} s audio -> "
        f"{args.output} | {stages} | total={res.total_seconds:.3f}s "
        f"RTF={res.rtf:.4f} ({eng.device})")
    if res.first_audio_seconds is not None:
        say(f"First audio: {res.first_audio_seconds:.3f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
