"""Convert and inspect Qwen3-TTS checkpoints with the port. Twin of
tools/convert_weights.py.

    HF model.safetensors -> params.npz (one file, the JAX package's
    format: either package loads it, with its TTSConfig embedded)

    python -m qwen3_tts_tpu_torch.tools.convert_weights --model_dir DIR \\
        --output params.npz [--dtype bfloat16] [--quantize int8|int8-cp] \\
        [--dump_embeddings DIR] [--device cuda]
    python -m qwen3_tts_tpu_torch.tools.convert_weights --model_dir DIR \\
        --speech_tokenizer --output vocoder.npz   # and encoder.npz
    python -m qwen3_tts_tpu_torch.tools.convert_weights --model_dir DIR \\
        --list_keys [--check_schema] | --detect_config
    python -m qwen3_tts_tpu_torch.tools.convert_weights --random \\
        --output params.npz [--tiny]

``--quantize int8`` writes the int8 talker and code predictor (the
engine's fastest artifact), ``int8-cp`` only the code predictor; an
input that is already quantized is refused. The weights are quantized
on ``--device`` (default cuda: the card's bits, which the engine there
would compute; it raises without a card); ``--random`` draws there too."""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model_dir", default=None)
    p.add_argument("--random", action="store_true",
                   help="random weights at the model geometry (development)")
    p.add_argument("--output", default="params.npz")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--speech_tokenizer", action="store_true",
                   help="convert <model_dir>/speech_tokenizer/"
                        "model.safetensors (or model_dir's own) into "
                        "vocoder.npz and encoder.npz instead")
    p.add_argument("--list_keys", action="store_true",
                   help="print every tensor's name, dtype and shape from "
                        "the headers of model.safetensors and "
                        "speech_tokenizer/model.safetensors (no weights "
                        "read)")
    p.add_argument("--check_schema", action="store_true",
                   help="with --list_keys: run the strict vocoder and "
                        "encoder loaders on zeros of the speech "
                        "tokenizer's declared shapes and report each "
                        "mismatched name")
    p.add_argument("--detect_config", action="store_true",
                   help="print the geometry read from the checkpoint's "
                        "header (io/weights.detect_tts_config) as JSON")
    p.add_argument("--dump_embeddings", default=None,
                   help="also write the text/codec embedding .npy files")
    p.add_argument("--quantize", default=None, choices=["int8", "int8-cp"],
                   help="write a pre-quantized artifact: 'int8' the talker "
                        "and the code predictor, 'int8-cp' the code "
                        "predictor only; the vocoder stays FP32")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the weights are quantized (and --random "
                        "drawn)")
    args = p.parse_args(argv)

    import torch

    from qwen3_tts_tpu_torch.config import TTSConfig, tiny_tts_config
    from qwen3_tts_tpu_torch.io import weights as weights_io
    from qwen3_tts_tpu_torch.ops import quant

    cfg = tiny_tts_config() if args.tiny else TTSConfig()
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    device = torch.device(args.device)

    if args.detect_config:
        if args.model_dir is None:
            p.error("--detect_config requires --model_dir")
        import dataclasses
        import json
        det = weights_io.detect_tts_config(args.model_dir, base=cfg)
        print(json.dumps({"talker": dataclasses.asdict(det.talker),
                          "code_predictor":
                              dataclasses.asdict(det.code_predictor)},
                         indent=2))
        return 0

    if args.list_keys:
        if args.model_dir is None:
            p.error("--list_keys requires --model_dir")
        return _list_keys(args, cfg)

    if args.speech_tokenizer:
        if args.model_dir is None:
            p.error("--speech_tokenizer requires --model_dir")
        st_dir = os.path.join(args.model_dir, "speech_tokenizer")
        if not os.path.exists(os.path.join(st_dir, "model.safetensors")):
            st_dir = args.model_dir
        print(f"Loading speech tokenizer: {st_dir}")
        st = weights_io.load_speech_tokenizer(st_dir, cfg)
        out = args.output if args.output != "params.npz" else "vocoder.npz"
        print(f"Saving: {out}")
        weights_io.save_pytree_npz(out, st["vocoder"])
        if "encoder" in st:
            # beside it, "vocoder" -> "encoder" in the file's name (the JAX
            # tool replaces it in the whole path, and overwrites the
            # vocoder when the name lacks it)
            head, name = os.path.split(out)
            enc_name = name.replace("vocoder", "encoder")
            enc_out = os.path.join(head, enc_name if enc_name != name
                                   else "encoder.npz")
            weights_io.save_pytree_npz(enc_out, st["encoder"])
            print(f"Saving: {enc_out}")
        print(f"  {os.path.getsize(out) / 1e6:.1f} MB")
        print("Done.")
        return 0

    if args.random or args.model_dir is None:
        print("Initializing random parameters at model geometry...")
        params = weights_io.init_random_params(cfg, seed=0, dtype=dtype,
                                               device=device)
    else:
        print(f"Loading HF checkpoint: {args.model_dir}")
        if os.path.exists(os.path.join(args.model_dir, "model.safetensors")):
            cfg = weights_io.detect_tts_config(args.model_dir, base=cfg)
        else:
            npz = os.path.join(args.model_dir, "params.npz")
            if os.path.exists(npz):
                # a native artifact (e.g. to quantize it): its embedded
                # config holds what shapes do not give
                cfg = weights_io.read_npz_config(npz) or cfg
        params = weights_io.load_params(args.model_dir, cfg, dtype,
                                        device=device)

    if args.quantize:
        if (quant.is_quantized(params.get("talker", {}))
                or quant.is_quantized(params.get("code_predictor", {}))):
            p.error("--quantize: the input checkpoint is already "
                    "quantized (QTensor weights); quantizing again would "
                    "compound the rounding: load the original dense "
                    "checkpoint instead")
        print(f"Quantizing ({args.quantize}; vocoder stays FP32)...")
        if args.quantize == "int8":
            params["talker"] = quant.quantize_talker(params["talker"])
        params["code_predictor"] = quant.quantize_code_predictor(
            params["code_predictor"])

    print(f"Saving native checkpoint: {args.output}")
    weights_io.save_pytree_npz(args.output, params, config=cfg)
    print(f"  {os.path.getsize(args.output) / 1e6:.1f} MB")

    if args.dump_embeddings:
        import numpy as np
        os.makedirs(args.dump_embeddings, exist_ok=True)
        tp = params["talker"]
        head = tp["codec_head"]
        if isinstance(head, quant.QTensor):
            head = quant.dequantize(head, torch.float32)
        dumps = {
            "text_embedding.npy": tp["text_embedding"],
            "codec_embedding.npy": tp["codec_embedding"],
            "codec_head.npy": head.T,  # (V, H) as the reference's
            "text_projection_linear_fc1_weight.npy": tp["proj_fc1_w"].T,
            "text_projection_linear_fc1_bias.npy": tp["proj_fc1_b"],
            "text_projection_linear_fc2_weight.npy": tp["proj_fc2_w"].T,
            "text_projection_linear_fc2_bias.npy": tp["proj_fc2_b"],
        }
        for name, t in dumps.items():
            arr = t.float().cpu().numpy()
            np.save(os.path.join(args.dump_embeddings, name), arr)
            print(f"  {name}: {arr.shape}")

    print("Done.")
    return 0


def _list_keys(args, cfg) -> int:
    """The headers' keys (and with --check_schema the strict loaders' dry
    run); 1 when a checkpoint or a loader's names are missing."""
    import torch

    from qwen3_tts_tpu_torch.io import weights as weights_io
    from qwen3_tts_tpu_torch.io.safetensors import list_safetensors_keys
    from qwen3_tts_tpu_torch.models import encoder as enc

    candidates = []
    for label, path in (
            ("model", os.path.join(args.model_dir, "model.safetensors")),
            ("speech_tokenizer", os.path.join(args.model_dir,
                                              "speech_tokenizer",
                                              "model.safetensors"))):
        if os.path.exists(path):
            candidates.append((label, path))
    if not candidates:
        print(f"no model.safetensors under {args.model_dir}",
              file=sys.stderr)
        return 1

    st_keys = None
    for label, path in candidates:
        keys = list_safetensors_keys(path)
        print(f"# {label}: {path} ({len(keys)} tensors)")
        for k in sorted(keys):
            dt, shape = keys[k]
            print(f"{k}\t{dt}\t{list(shape)}")
        if label == "speech_tokenizer":
            st_keys = keys

    if not args.check_schema:
        return 0
    if st_keys is None:
        print("\n--check_schema: no speech_tokenizer checkpoint found",
              file=sys.stderr)
        return 1
    zeros = {k: torch.zeros(shape) for k, (_, shape) in st_keys.items()}
    groups = weights_io.split_speech_tokenizer_state_dict(zeros)
    checks = [("decoder (vocoder)", groups.get("decoder"),
               lambda sd: weights_io.load_vocoder_from_state_dict(
                   sd, cfg.vocoder)),
              ("encoder (voice clone)", groups.get("encoder"),
               lambda sd: enc.load_encoder_from_state_dict(sd, cfg.encoder))]
    rc = 0
    for label, sd, loader in checks:
        if not sd:
            print(f"\nSCHEMA {label}: NO '{label.split()[0]}.' tensors in "
                  "the checkpoint")
            rc = 1
            continue
        try:
            loader(sd)
            print(f"\nSCHEMA {label}: OK — every expected name present, "
                  "every checkpoint tensor consumed")
        except (KeyError, ValueError) as e:
            print(f"\nSCHEMA {label}: MISMATCH — {e}")
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
