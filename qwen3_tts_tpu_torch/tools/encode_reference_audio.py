"""Encode a reference WAV into (T, 16) codec tokens for voice cloning,
with the port. Twin of tools/encode_reference_audio.py.

WAV -> linear resample to 24 kHz -> zero-pad to whole tokens -> the
speech tokenizer's encoder (models/encoder.py) -> codec tokens, written
as a prompt dir (``ref_codec_tokens.npy`` int64 and ``ref_text.txt``,
what ``TTSEngine(prompt_dir=...)`` reads in either package) or as one
.npy; then a decode-back WAV through the vocoder's left-context chunks,
to listen to what the tokens carry.

    python -m qwen3_tts_tpu_torch.tools.encode_reference_audio \\
        --audio ref.wav --output_dir prompt_dir \\
        --ref_text "text spoken in the audio" \\
        [--model_dir DIR] [--device cuda|cpu] [--tiny]

``--model_dir`` is resolved by io/weights.load_params at the default
geometry (``--tiny``: the tiny one); a checkpoint without ``encoder.*``
tensors gets a random encoder, with a warning. ``--device cuda`` (the
default) raises without a card."""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--audio", required=True)
    p.add_argument("--output", default="ref_codec_tokens.npy")
    p.add_argument("--output_dir", default=None,
                   help="write a prompt dir (tokens + ref_text.txt)")
    p.add_argument("--ref_text", default=None)
    p.add_argument("--max_tokens", type=int, default=256)
    p.add_argument("--model_dir", default=None)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--tiny", action="store_true")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from qwen3_tts_tpu_torch.config import (SAMPLE_RATE, TTSConfig,
                                            tiny_tts_config)
    from qwen3_tts_tpu_torch.io import wav as wav_io
    from qwen3_tts_tpu_torch.io import weights as weights_io
    from qwen3_tts_tpu_torch.models import encoder as enc
    from qwen3_tts_tpu_torch.models import vocoder as voc

    cfg = tiny_tts_config() if args.tiny else TTSConfig()
    device = torch.device(args.device)

    wav, sr = wav_io.read_wav(args.audio)
    print(f"Audio: {args.audio}  duration={len(wav) / sr:.2f}s sr={sr}")
    wav = enc.pad_to_tokens(enc.resample_linear(wav, sr, SAMPLE_RATE))

    params = weights_io.load_params(args.model_dir, cfg, device=device)
    if "encoder" not in params:
        print("WARNING: no trained encoder weights found (checkpoint has "
              "no encoder.* tensors) — the encoder is RANDOMLY INITIALIZED "
              "and the emitted ref_codec_tokens.npy will NOT carry the "
              "reference speaker's voice. Check the decode-back WAV before "
              "using this prompt_dir.", file=sys.stderr)
        params["encoder"] = weights_io.to_device(
            {"encoder": enc.init_encoder_params(cfg.encoder, seed=0)},
            device)["encoder"]
    vp = params["vocoder"]
    codebooks = enc.decoder_codebooks(vp, cfg.vocoder)

    with torch.inference_mode():
        x = torch.from_numpy(wav)[None].to(device)
        codes = enc.encode(params["encoder"], codebooks, x,
                           cfg.encoder)[0].cpu().numpy()
    n_tokens = min(len(codes), args.max_tokens)
    codes = codes[:n_tokens].astype(np.int64)
    print(f"Tokens: {n_tokens}  groups: {codes.shape[1]}  "
          f"audio-from-tokens: {n_tokens / 12.5:.2f}s")

    if args.output_dir:
        os.makedirs(args.output_dir, exist_ok=True)
        np.save(os.path.join(args.output_dir, "ref_codec_tokens.npy"), codes)
        if args.ref_text:
            with open(os.path.join(args.output_dir, "ref_text.txt"),
                      "w") as f:
                f.write(args.ref_text)
        print(f"Saved prompt_dir: {args.output_dir}")
        decoded_path = os.path.join(args.output_dir, "ref_decoded.wav")
    else:
        # np.save appends .npy when it is missing: name the real file
        out = (args.output if args.output.endswith(".npy")
               else args.output + ".npy")
        np.save(out, codes)
        print(f"Saved: {out}")
        decoded_path = os.path.splitext(out)[0] + "_decoded.wav"

    # decode-back through the vocoder's left-context chunks
    with torch.inference_mode():
        audio = voc.synthesize_chunked_context(
            lambda c: voc.decode(vp, c, cfg.vocoder),
            codes.astype(np.int32), device=device)
    wav_io.write_wav(decoded_path, voc.to_int16(audio))
    print(f"Saved decode-back verification: {decoded_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
