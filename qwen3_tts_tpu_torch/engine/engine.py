"""TTSEngine: synthesis, text -> codes -> 24 kHz int16 audio, one
request (``synthesize``, whole or streamed), several in one batched
decode (``synthesize_batch``), or a paragraph in sentence pieces
(``synthesize_long``). Twin of qwen3_tts_tpu/engine/engine.py.

tokenize -> dual-stream prefix -> talker prefill -> decode loop
(engine/generate.py) -> FP32 vocoder -> optional WAV. The post-prefill
state of a prefix is kept in a small LRU (``_prefix_cache``, 4 entries)
and, with ``kv_cache_dir`` set, in an npz file the JAX engine reads too;
a request decodes a copy of it, since the loop updates the KV cache and
the codes buffer in place. ``prompt_dir`` clones a voice: the reference
transcript and codec frames join the prefix (models/talker.
build_prefix_cloned). A non-streaming request launches the vocoder on
the device codes buffer, padded to voc_bucket(EOS-pacing bound + 1)
tokens, right after the decode and before any host read (the chain;
``QWEN3_TTS_FUSED_VOCODER=0`` turns it off), then fetches the token
count, the codes and the audio together; without the chain, or past the
largest vocoder bucket, it fetches the codes and vocodes them through
``vocoder.synthesize_exact`` (one window of voc_bucket(n + 1) tokens up
to 256 tokens, left-context chunks past that). ``streaming=True`` decodes
the head in chunks of 8 and 56 tokens, then the rest in one call, and
hands each piece of audio to ``on_chunk`` as soon as it is final. How it
vocodes is read from ``QWEN3_TTS_ENGINE_STREAM`` at each call:
"window" (the default) vocodes prefix windows of the codes buffer and
keeps each window's new samples: the non-streaming audio wherever the
vocoder's sums do not depend on the window's width (bit for bit on the
CPU; on the card cuBLAS picks its GEMM kernel by the row count, within
+-1 LSB); "incremental" rides the incremental vocoder stream (models/
vocoder_stream: O(new tokens) an emission, within +-1 LSB of it).
``SynthesisResult.first_audio_seconds`` is the wall time until the first
samples reach the host. With ``quantize="int8"`` (or int8 trees in
``params``) the decode loop runs the hand-written kernels K1 (int8
products), K2 (code predictor steps) and K3 (talker decode step, up to 8
rows); ``quantize="int8-cp"`` keeps the talker dense (K1 and K2 only);
with ``TalkerConfig(attention_impl="pallas")`` a per-layer talker step's
attention runs on K5. ``mesh`` shards the engine over a tp group
(parallel/mesh.py): every rank of the group calls it with the same
arguments and returns the same result.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import os
import sys
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from qwen3_tts_tpu_torch.config import (
    SAMPLE_RATE,
    SAMPLES_PER_TOKEN,
    SUPPORTED_LANGUAGES,
    VOC_CHUNK_SIZE,
    SamplingConfig,
    TTSConfig,
)
from qwen3_tts_tpu_torch.engine import generate as gen
from qwen3_tts_tpu_torch.io import wav as wav_io
from qwen3_tts_tpu_torch.io import weights as weights_io
from qwen3_tts_tpu_torch.io.tokenizer import load_tokenizer
from qwen3_tts_tpu_torch.models import talker as tk
from qwen3_tts_tpu_torch.models import vocoder as voc
from qwen3_tts_tpu_torch.models import vocoder_stream as vstream
from qwen3_tts_tpu_torch.models.code_predictor import CodePredictor
from qwen3_tts_tpu_torch.ops import quant
from qwen3_tts_tpu_torch.ops import sampling as smp
from qwen3_tts_tpu_torch.parallel import mesh as pmesh
from qwen3_tts_tpu_torch.utils.profiling import stage as _stage
from qwen3_tts_tpu_torch.utils.text import piece_token_budget, split_for_budget


@dataclasses.dataclass
class SynthesisResult:
    audio_int16: np.ndarray           # mono 24 kHz
    codes: np.ndarray                 # (n_tokens, 16)
    n_tokens: int
    timings: Dict[str, float]
    total_seconds: float
    rtf: float
    # wall seconds from the call until the first samples reached the
    # host; None when no token was generated
    first_audio_seconds: Optional[float] = None

    @property
    def audio_seconds(self) -> float:
        return len(self.audio_int16) / SAMPLE_RATE


_TEXT_BUCKETS = (16, 32, 64, 128, 256)


def _bucket(n: int) -> int:
    for b in _TEXT_BUCKETS:
        if n <= b:
            return b
    return _TEXT_BUCKETS[-1]


def _pacing_bound(budget_cap: int, n_text: int,
                  scfg: Optional[SamplingConfig] = None) -> int:
    """Tightest known bound on generated tokens. For n_text > 0 the
    EOS-pacing force (progress > eos_force_progress, ops/sampling.py)
    gives n <= expected_tokens_per_text_token * eos_force_progress *
    n_text + 1 (the reference defaults when ``scfg`` is None); n_text == 0
    disables pacing, so only the budget bounds the decode."""
    if n_text <= 0:
        return budget_cap
    scfg = scfg or SamplingConfig()
    mult = scfg.expected_tokens_per_text_token * scfg.eos_force_progress
    return min(budget_cap, int(math.ceil(mult * n_text)) + 2)


def _chained_voc_window(budget_cap: int, n_text: int,
                        scfg: Optional[SamplingConfig] = None) -> int:
    """The chained non-streaming vocoder's window (tokens): the bucket of
    the pacing bound plus one zero-code lookahead token."""
    return voc.voc_bucket(_pacing_bound(budget_cap, n_text, scfg) + 1)


STREAM_MODES = ("window", "incremental")


def _stream_mode() -> str:
    """The engine's streaming mode, read at each call:
    ``QWEN3_TTS_ENGINE_STREAM``, "window" by default."""
    mode = os.environ.get("QWEN3_TTS_ENGINE_STREAM", "window")
    if mode not in STREAM_MODES:
        raise ValueError(f"QWEN3_TTS_ENGINE_STREAM={mode!r}: expected one "
                         f"of {STREAM_MODES}")
    return mode


def _to_host(*ts: torch.Tensor) -> List[torch.Tensor]:
    """Copies of device tensors on the host, started together
    (non-blocking) and waited for once."""
    out = [t.to("cpu", non_blocking=True) for t in ts]
    if ts[0].is_cuda:
        torch.cuda.current_stream(ts[0].device).synchronize()
    return out


def vocode(vp: Dict, codes: np.ndarray, cfg, device) -> np.ndarray:
    """codes (n, 16) -> int16 audio (n * 1920,) through the vocoder
    weights vp: voc.synthesize_exact (one window of voc_bucket(n + 1)
    tokens up to 256, so the last token has a zero-code lookahead token;
    left-context chunks past that), converted to int16 on the device."""
    return voc.to_int16(voc.synthesize_exact(voc.int16_decoder(vp, cfg),
                                             codes, device=device))


class TTSEngine:
    """Single-request TTS engine on one device or a tp ``mesh`` (below).
    ``model_dir`` loads a checkpoint (io/weights.load_params: a
    ``params.npz`` of either package, or an HF directory with
    ``model.safetensors`` and ``speech_tokenizer/``), its geometry too
    when ``cfg`` is None, and its
    tokenizer (io/tokenizer.load_tokenizer); ``model_dir=None`` runs with
    random weights drawn from ``seed``; ``params`` supplies weights in the
    port's layout (io/weights.py) instead. ``quantize``: None
    (dense), "int8" (talker and code predictor) or "int8-cp" (only the
    code predictor; a dense talker in ``dtype``). A talker or code
    predictor in ``params`` that is already int8 (quant.quantize_talker,
    quantize_code_predictor) is kept as it is, except that "int8-cp"
    dequantizes an int8 talker (quant.dequantize_talker); the halves that
    ``quantize`` asks for and are still dense are quantized, and
    ``self.quantize`` reports the state: "int8", "int8-cp" (only the code
    predictor) or "int8-talker" (only the talker).

    ``kv_cache_dir`` (an attribute, None by default): a directory where
    post-prefill states are also kept as ``qwen3_kv_<hash>.npz`` files,
    the JAX engine's format and names.

    ``mesh``: a tensor-parallel parallel.mesh.Mesh (dp must be 1: dp
    batching belongs to ContinuousBatcher(mesh=...)). The engine runs on
    the rank's ``mesh.device``; the talker and the code predictor hold
    this rank's shards (parallel/mesh.shard_params), the KV cache its kv
    heads, and each layer adds up its row-parallel products over the tp
    group. The talker is dense ("int8" is refused; a pre-quantized talker
    is dequantized to ``dtype``), the code predictor dense or int8
    ("int8-cp": under tp its products run on K1 over the shards, as K2
    holds whole heads). Every rank of the group calls the engine with the
    same arguments and gets the same result. ``kv_cache_dir`` files hold
    whole states under tp too (the kv heads gathered over the group, tp
    rank 0 writing), so either engine reads the other's."""

    def __init__(self, cfg: Optional[TTSConfig] = None,
                 model_dir: Optional[str] = None,
                 dtype=torch.bfloat16, seed: int = 0,
                 params: Optional[Dict] = None,
                 quantize: Optional[str] = None,
                 device="cuda", mesh=None):
        if quantize not in (None, "int8", "int8-cp"):
            raise ValueError(f"unsupported quantize={quantize!r}")
        if mesh is not None:
            if mesh.shape[pmesh.DP] != 1:
                raise ValueError(
                    f"TTSEngine mesh must be tensor-parallel only (dp=1), "
                    f"got {mesh.shape} — dp batching belongs to "
                    "ContinuousBatcher(mesh=...)")
            if quantize == "int8":
                raise ValueError(
                    "quantize='int8' uses the fused single-chip talker "
                    "layout (no mesh sharding specs); with a mesh use "
                    "quantize='int8-cp' or None")
            device = mesh.device
        self.mesh = mesh
        self.device = torch.device(device)
        # seconds of loading a model_dir: "read", "map", "to_device"
        self.load_seconds: Dict[str, float] = {}
        if cfg is None and model_dir is not None:
            # the geometry from the checkpoint, in load_params' order:
            # params.npz (its embedded config, else its shapes), then the
            # safetensors header
            npz = os.path.join(model_dir, "params.npz")
            if os.path.exists(npz):
                cfg = weights_io.read_npz_config(npz)
                if params is None:
                    params = weights_io.load_params(
                        model_dir, TTSConfig(), dtype, seed, self.device,
                        self.load_seconds)
                if cfg is None:
                    cfg = weights_io.config_from_params(params)
            elif os.path.exists(os.path.join(model_dir,
                                             "model.safetensors")):
                cfg = weights_io.detect_tts_config(model_dir)
        self.cfg = cfg or TTSConfig()
        params = (dict(params) if params is not None else
                  weights_io.load_params(model_dir, self.cfg, dtype, seed,
                                         self.device, self.load_seconds))
        pre_t = quant.is_quantized(params["talker"])
        pre_c = quant.is_quantized(params["code_predictor"])
        if pre_t or pre_c:
            # never quantize twice; an int8 talker under "int8-cp" is
            # made dense, and a dense half that quantize asks for is
            # quantized
            if pre_t and (quantize == "int8-cp" or mesh is not None):
                if mesh is not None and quantize != "int8-cp":
                    print(f"TTSEngine: pre-quantized talker -> dense "
                          f"{dtype} for the mesh tier (the fused int8 "
                          "layout is single-chip)", file=sys.stderr)
                params["talker"] = quant.dequantize_talker(params["talker"],
                                                           dtype)
                pre_t = False
            if not pre_t and quantize == "int8":
                params["talker"] = quant.quantize_talker(params["talker"])
                pre_t = True
            if not pre_c and quantize in ("int8", "int8-cp"):
                params["code_predictor"] = quant.quantize_code_predictor(
                    params["code_predictor"])
                pre_c = True
            quantize = ("int8" if pre_t and pre_c
                        else "int8-cp" if pre_c else "int8-talker")
        elif quantize in ("int8", "int8-cp"):
            if quantize == "int8":
                params["talker"] = quant.quantize_talker(params["talker"])
            params["code_predictor"] = quant.quantize_code_predictor(
                params["code_predictor"])
        self.quantize = quantize
        if mesh is not None:
            params = pmesh.shard_params(mesh, params)
        c = self.cfg
        self.talker = tk.Talker(c.talker, params["talker"]).to(self.device)
        self.code_predictor = CodePredictor(
            c.code_predictor, params["code_predictor"]).to(self.device)
        self.vocoder = voc.Vocoder(c.vocoder,
                                   params["vocoder"]).to(self.device)
        self._tp = self.talker.weights()
        self._cpp = self.code_predictor.weights()
        self._vp = self.vocoder.weights()
        self.tokenizer = load_tokenizer(model_dir)
        # streaming: first audio after 8 tokens, one more chunk of 56 to
        # bank playout headroom, then the rest in one run_steps call
        self.head_schedule = (8, 56)
        self._stream_stepper = vstream.StreamStepper(c.vocoder)
        # (1, W, 16) int32 codes on the device -> (1, W * 1920) int16 there
        self._voc = voc.int16_decoder(self._vp, c.vocoder)
        self._chained_vocode = (
            os.environ.get("QWEN3_TTS_FUSED_VOCODER", "1") != "0")
        # post-prefill states by prefix, least recently used first
        self._prefix_cache: "OrderedDict[tuple, gen.GenState]" = \
            OrderedDict()
        self._prefix_cache_cap = 4
        self.kv_cache_dir: Optional[str] = None

    @property
    def params(self) -> Dict:
        """The weight trees on the engine's device, in the layout that
        ContinuousBatcher takes (the batched daemon shares them)."""
        return {"talker": self._tp, "code_predictor": self._cpp,
                "vocoder": self._vp}

    def _encode_text(self, text: str) -> Tuple[np.ndarray, int]:
        """Token ids on the host, padded to a bucket that fits the KV
        allocation; text past it is truncated with a warning. Returns
        (ids np.int32, n)."""
        ids = self.tokenizer.encode(text, add_special_tokens=False)
        b = min(_bucket(len(ids)), self._text_cap())
        if len(ids) > b:
            print(f"warning: text truncated to {b} of {len(ids)} tokens "
                  f"(max_seq_len={self.cfg.talker.max_seq_len}); use "
                  f"synthesize_long / --long for paragraph-length text",
                  file=sys.stderr)
        padded = np.zeros((b,), np.int32)
        n = min(len(ids), b)
        padded[:n] = ids[:n]
        return padded, n

    def _text_cap(self) -> int:
        """The largest text bucket whose prefix fits the KV allocation."""
        limit = self.cfg.talker.max_seq_len - tk.PREFIX_EXTRA
        fits = [bk for bk in _TEXT_BUCKETS if bk <= limit]
        return fits[-1] if fits else max(limit, 1)

    def vocode(self, codes: np.ndarray) -> np.ndarray:
        """codes (n, 16) -> int16 audio (n * 1920,) through
        voc.synthesize_exact (see the module function ``vocode``)."""
        return vocode(self._vp, codes, self.cfg.vocoder, self.device)

    # -- prefixes and their post-prefill states ------------------------
    def _prefill_state(self, ids: np.ndarray, n_text: int, n_pace: int,
                       ref=None) -> gen.GenState:
        """Prefix and talker prefill: the post-prefill state that the
        prefix cache keeps (cloned with ``ref``, tk.request_prefix). EOS
        pacing counts ``n_pace`` text tokens."""
        prefix, plen = tk.request_prefix(self._tp, self._cpp["codec_embs"],
                                         ids, n_text, ref, self.mesh)
        n_pace_t = torch.tensor([n_pace], dtype=torch.int32,
                                device=self.device)
        return gen.init_state(self._tp, prefix[None], plen[None], n_pace_t,
                              smp.batch_keys(0, 1), self.cfg,
                              mesh=self.mesh)

    def _cache_get(self, k) -> Optional[gen.GenState]:
        snap = self._prefix_cache.get(k)
        if snap is not None:
            self._prefix_cache.move_to_end(k)
        return snap

    def _cache_put(self, k, snap: gen.GenState) -> None:
        self._prefix_cache[k] = snap
        while len(self._prefix_cache) > self._prefix_cache_cap:
            self._prefix_cache.popitem(last=False)

    def _request_state(self, snap: gen.GenState, seed: int,
                       budget_cap: int) -> gen.GenState:
        """One request's loop state: a copy of the snapshot with the
        request's key and token budget."""
        return gen.copy_state(
            snap, key=smp.batch_keys(seed, 1).to(self.device),
            budget=torch.tensor([budget_cap], dtype=torch.int32,
                                device=self.device))

    def _prefill(self, ids: np.ndarray, n_text: int, seed: int,
                 budget_cap: int) -> gen.GenState:
        """The request's post-prefill state through the prefix cache:
        memory, then the ``kv_cache_dir`` file, then a prefill (saved to
        that file). The key is built from the host ids."""
        k = (tuple(ids.tolist()), int(n_text))
        snap = self._cache_get(k)
        if snap is None:
            path = None
            if self.kv_cache_dir is not None:
                h = hashlib.md5(ids.astype(np.int32).tobytes()
                                + str(int(n_text)).encode()).hexdigest()
                path = os.path.join(self.kv_cache_dir,
                                    f"qwen3_kv_{h[:16]}.npz")
                snap = self._load_shared(path)
                if snap is not None:
                    path = None             # no need to save it again
            if snap is None:
                snap = self._prefill_state(ids, n_text, n_text)
                if path is not None:
                    try:
                        self._save_state_npz(path, snap)
                    except OSError as e:
                        print(f"warning: prefix cache file {path} not "
                              f"written ({e})", file=sys.stderr)
            self._cache_put(k, snap)
        return self._request_state(snap, seed, budget_cap)

    def _load_shared(self, path: str) -> Optional[gen.GenState]:
        """The state in the ``kv_cache_dir`` file ``path``, or None (no
        file, or an unreadable one: the caller prefills). Under tp the
        choice is one for the whole group: tp rank 0 reads the file and
        broadcasts whether it loaded, and only then do the other ranks
        read it (a rank that loads while another prefills would hang in
        the prefill's collectives)."""
        tp = pmesh.tp_active(self.mesh)
        snap = None
        if not tp or self.mesh.tp_index == 0:
            if os.path.exists(path):
                try:
                    snap = self._load_state_npz(path)
                except Exception as e:  # any unreadable file
                    print(f"warning: prefix cache file {path} not "
                          f"loaded ({e}); recomputing", file=sys.stderr)
        if not tp:
            return snap
        loaded = pmesh.tp_broadcast_flag(snap is not None, self.mesh)
        if loaded and snap is None:
            # rank 0 read the whole file; a failure here cannot be
            # recovered alone
            snap = self._load_state_npz(path)
        return snap if loaded else None

    def _save_state_npz(self, path: str, state: gen.GenState) -> None:
        """A post-prefill state as an npz of the JAX engine's fields:
        bf16 as f32 (npz has no bf16), and ``step``, the JAX loop's
        counter, as 0. Under tp the kv heads are gathered over the group
        (every rank takes part) in the order shard_params split them, and
        tp rank 0 writes the whole state, the one-device engine's file;
        the file appears whole (written aside, then renamed)."""
        flat = {"step": np.zeros((), np.int32)}
        for f in dataclasses.fields(state):
            a = getattr(state, f.name)
            if f.name == "kv" and pmesh.tp_active(self.mesh):
                # (L, 2, B, S, Hkv/tp, Dh): heads to the last dim, gathered
                # in tp order, back to dim 4
                a = pmesh.tp_all_gather(a.movedim(4, -1).contiguous(),
                                        self.mesh).movedim(-1, 4)
            if a.dtype == torch.bfloat16:
                a = a.float()
            flat[f.name] = a.cpu().numpy()
        if self.mesh is not None and self.mesh.tp_index != 0:
            return
        tmp = f"{path}.{os.getpid()}.tmp.npz"
        try:
            np.savez(tmp, **flat)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def _load_state_npz(self, path: str) -> gen.GenState:
        """A state saved by this engine or the JAX one, whole; under tp
        this rank keeps its own kv heads. ``step`` and ``key`` are not
        read (a request brings its own key); a file without ``budget``
        loads with cfg.max_tokens; kv and hidden come back in the
        talker's dtype."""
        names = [f.name for f in dataclasses.fields(gen.GenState)
                 if f.name != "key"]
        with np.load(path) as data:
            arrays = {f: data[f] for f in names if f in data.files}
        B = arrays["pos"].shape[0]
        arrays.setdefault("budget",
                          np.full((B,), self.cfg.max_tokens, np.int32))
        tcfg = self.cfg.talker
        want = (tcfg.num_layers, 2, B, tcfg.max_seq_len, tcfg.num_kv_heads,
                tcfg.head_dim)
        if (tuple(arrays["kv"].shape) != want
                or arrays["codes"].shape[1:] != (self.cfg.max_tokens, 16)):
            raise ValueError(f"state of another geometry: kv "
                             f"{arrays['kv'].shape}, codes "
                             f"{arrays['codes'].shape}")
        if pmesh.tp_active(self.mesh):
            n = tcfg.num_kv_heads // self.mesh.shape[pmesh.TP]
            lo = self.mesh.tp_index * n
            arrays["kv"] = arrays["kv"][:, :, :, :, lo:lo + n]
        t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
             for k, v in arrays.items()}
        dt = self._tp["codec_embedding"].dtype
        t["kv"], t["hidden"] = t["kv"].to(dt), t["hidden"].to(dt)
        return gen.GenState(**t, key=smp.batch_keys(0, B).to(self.device))

    # -- voice cloning -------------------------------------------------
    def _load_prompt(self, prompt_dir: str):
        """A voice-cloning prompt dir: ref_codec_tokens.npy ((R, >= 16)
        codec frames) and an optional ref_text.txt (the reference
        transcript), the format tools/encode_reference_audio.py writes.
        Returns (codes (R, 16) np.int32, ref_text)."""
        try:
            codes = np.load(os.path.join(prompt_dir, "ref_codec_tokens.npy"))
            codes = np.asarray(codes, np.int32)[:, :16]
        except (OSError, ValueError, IndexError) as e:
            raise ValueError(f"invalid prompt_dir {prompt_dir!r}: {e}") from e
        txt_path = os.path.join(prompt_dir, "ref_text.txt")
        ref_text = ""
        if os.path.exists(txt_path):
            with open(txt_path) as f:
                ref_text = f.read().strip()
        return codes, ref_text

    def _encode_cloned(self, text: str, ref_text: str):
        """Ids over ``ref_text + ' ' + text`` and the target text's own
        token count (EOS pacing). Raises ValueError when the two overflow
        the prefix bucket: truncation would cut the target's tail while
        the pacing still budgets for it. Returns (ids, n_text,
        n_target)."""
        full = (ref_text + " " + text).strip() if ref_text else text
        ids, n_text = self._encode_text(full)
        n_full = len(self.tokenizer.encode(full, add_special_tokens=False))
        if n_full > n_text:
            raise ValueError(
                f"voice-cloned text overflows the prefix: reference "
                f"transcript + target encode to {n_full} tokens but the "
                f"prefix holds {n_text} "
                f"(max_seq_len={self.cfg.talker.max_seq_len}); shorten "
                f"the reference transcript or use synthesize_long/--long")
        n_target = min(len(self.tokenizer.encode(
            text, add_special_tokens=False)), n_text)
        return ids, n_text, n_target

    def _cloned_piece_budget(self, budget: int, ref_text: str) -> int:
        """A paragraph piece's token budget tightened so that the
        reference transcript and the piece fit the text bucket (a margin
        of 2 for the separator and token boundaries); raises when the
        transcript alone leaves no room."""
        n_ref = len(self.tokenizer.encode(ref_text,
                                          add_special_tokens=False))
        room = self._text_cap() - n_ref - 2
        if room < 2:
            raise ValueError(
                f"reference transcript is too long for voice cloning: "
                f"{n_ref} tokens of a {self._text_cap()}-token prefix "
                f"budget; re-encode the prompt with a shorter ref_text")
        return max(2, min(budget, room))

    def _prefill_cloned(self, ids: np.ndarray, n_text: int, n_target: int,
                        ref_codes: np.ndarray, seed: int,
                        budget_cap: int) -> gen.GenState:
        """The cloned request's post-prefill state through the prefix
        cache: the reference frames clamped to the KV allocation and
        bucketed (tk.cloned_ref_limit, tk.bucket_ref_frames), keyed by
        (ids, n_text, n_target, padded ref bytes, n_ref)."""
        S = self.cfg.talker.max_seq_len
        padded, n_ref = tk.bucket_ref_frames(
            tk.cloned_ref_limit(S, len(ids)), ref_codes)
        if n_ref < len(ref_codes):
            print(f"warning: reference audio truncated to {n_ref} frames "
                  f"(max_seq_len={S})", file=sys.stderr)
        k = (tuple(ids.tolist()), int(n_text), int(n_target),
             padded.tobytes(), int(n_ref))
        snap = self._cache_get(k)
        if snap is None:
            snap = self._prefill_state(ids, n_text, n_target,
                                       (padded, n_ref))
            self._cache_put(k, snap)
        return self._request_state(snap, seed, budget_cap)

    def _run(self, state: gen.GenState, steps: int) -> gen.GenState:
        return gen.run_steps(self._tp, self._cpp, state, self.cfg, steps,
                             self.mesh)

    @staticmethod
    def _status(state: gen.GenState) -> tuple:
        """(done, n_codes) of row 0, in one device read."""
        st = torch.stack([state.done[:1].to(torch.int32),
                          state.n_codes[:1]]).cpu()
        return bool(st[0, 0]), int(st[1, 0])

    @torch.inference_mode()
    def synthesize(self, text: str, language: str = "russian",
                   output: Optional[str] = None, streaming: bool = False,
                   seed: int = 0, prompt_dir: Optional[str] = None,
                   max_tokens: Optional[int] = None,
                   on_chunk=None) -> SynthesisResult:
        """Full pipeline: text -> codes -> audio. ``language`` is
        validated but, as in the reference, does not change the prefix.
        ``prompt_dir``: a voice-cloning prompt (``_load_prompt``); the
        reference speaker's frames condition the decode in-context.
        ``max_tokens`` caps this request's tokens. ``on_chunk`` (with
        ``streaming=True``) is called with each np.int16 piece of audio as
        soon as it is final; the pieces concatenate to ``audio_int16``.
        Codes do not depend on ``streaming``, nor, on the CPU, does the
        audio in the default "window" stream mode (``_stream_mode``). The
        WAV is written when ``output`` is given and audio was
        generated."""
        if language not in SUPPORTED_LANGUAGES:
            raise ValueError(f"unsupported language {language!r}; expected "
                             f"one of {SUPPORTED_LANGUAGES}")
        mode = _stream_mode() if streaming else None
        budget = self.cfg.max_tokens
        if max_tokens is not None:
            if max_tokens < 1:
                raise ValueError(f"max_tokens must be >= 1, got {max_tokens}")
            budget = min(int(max_tokens), budget)

        timings: Dict[str, float] = {}
        t_start = time.perf_counter()
        with _stage(timings, "tokenize"):
            if prompt_dir is not None:
                ref_codes, ref_text = self._load_prompt(prompt_dir)
                ids, n_text, pace_n = self._encode_cloned(text, ref_text)
            else:
                ids, n_text = self._encode_text(text)
                # a cloned request paces EOS on the target's count alone
                pace_n = n_text

        def prefill() -> gen.GenState:
            if prompt_dir is None:
                return self._prefill(ids, n_text, seed, budget)
            return self._prefill_cloned(ids, n_text, pace_n, ref_codes,
                                        seed, budget)

        chained_W = _chained_voc_window(budget, pace_n, self.cfg.sampling)
        if (not streaming and self._chained_vocode
                and chained_W <= voc.VOC_BUCKETS[-1]):
            with _stage(timings, "decode+vocoder"):
                state = self._run(prefill(), budget)
                # launched before any host read: the fetch below waits
                # for the decode and the vocoder together. Rows past n are
                # zero codes, so causality makes audio[:n * 1920] that of
                # a window of voc_bucket(n + 1) tokens (up to the order of
                # sums, which on the card depends on the width)
                out = self._voc(voc.pad_codes(state.codes, chained_W))
                n_h, codes_h, audio_h = _to_host(state.n_codes[:1],
                                                 state.codes[0], out[0])
                n = int(n_h[0])
                codes = codes_h[:n].numpy()
                audio = audio_h[:n * SAMPLES_PER_TOKEN].numpy()
                if n >= chained_W:
                    # no lookahead row for the last token: a decode past
                    # the pacing bound, which the EOS force rules out
                    # unless the loop was replaced (tests)
                    audio = self.vocode(codes)
            first = time.perf_counter() - t_start
        elif not streaming:
            with _stage(timings, "decode"):
                state = self._run(prefill(), budget)
                n = int(state.n_codes[0])
                codes = state.codes[0, :n].cpu().numpy()
            with _stage(timings, "vocoder"):
                audio = self.vocode(codes)
            first = time.perf_counter() - t_start
        else:
            with _stage(timings, "prefill"):
                # the first head chunk runs with the prefill
                state = self._run(prefill(),
                                  min(self.head_schedule[0], budget))
            stream = (self._stream_window if mode == "window"
                      else self._stream)
            with _stage(timings, "decode+vocoder"):
                audio, n, codes, first = stream(state, budget, pace_n,
                                                on_chunk, t_start)
        audio = voc.to_int16(audio)
        if output and len(audio):
            wav_io.write_wav(output, audio)
        total = time.perf_counter() - t_start
        seconds = len(audio) / SAMPLE_RATE
        return SynthesisResult(
            audio_int16=audio, codes=codes, n_tokens=n,
            timings=timings, total_seconds=total,
            rtf=total / seconds if seconds > 0 else float("inf"),
            first_audio_seconds=first if n > 0 else None)

    def _stream_window(self, state, budget: int, pace_n: int, on_chunk,
                       t_start: float):
        """Streaming in prefix windows ("window" mode, the default): after
        each head chunk the vocoder decodes codes[:, :W] with W =
        voc_bucket(decoded), and the samples of tokens [rendered, decoded -
        1) are kept: the last decoded token is the kept tokens' lookahead.
        After the last decode call the windows up to the EOS-pacing bound
        are launched before the token count is read, each trimmed to it
        (a window past it is never fetched); past the bound, host windows
        zero-padded to voc_bucket(end + 1). Rows past the token count are
        zero codes, so every kept sample equals the non-streaming decode's
        where the vocoder's sums do not depend on the width (bit for bit
        on the CPU, within +-1 LSB on the card). A window reads the codes
        buffer, which the next decode call writes in place, in launch order
        on the one CUDA stream.
        Returns (int16 audio, n, codes, first-audio seconds)."""
        U = SAMPLES_PER_TOKEN
        T_buf = int(state.codes.shape[1])
        pending: List[list] = []   # [samples of the kept tokens, start, size]
        chunks: List[np.ndarray] = []
        rendered = decoded = flushed = 0
        first = None

        def launch(window: torch.Tensor, end: int) -> None:
            nonlocal rendered
            out = self._voc(window)[0, rendered * U:end * U]
            pending.append([out, rendered, end - rendered])
            rendered = end

        def flush(n_known: int) -> None:
            """Fetch the launched windows in order, trimming each to the
            known token count, and hand each piece to on_chunk."""
            nonlocal flushed, first
            while flushed < len(pending):
                out, start, size = pending[flushed]
                flushed += 1
                keep = min(size, max(n_known - start, 0))
                if keep <= 0:
                    continue
                a = out[:keep * U].cpu().numpy()
                chunks.append(a)
                if first is None:
                    first = time.perf_counter() - t_start
                if on_chunk is not None:
                    on_chunk(a)

        done = False
        for ci, step_budget in enumerate(self.head_schedule):
            step_budget = min(step_budget, budget - decoded)
            if step_budget <= 0:
                break
            if ci > 0:
                state = self._run(state, step_budget)
            decoded += step_budget
            if decoded - 1 > rendered:
                launch(state.codes[:, :min(voc.voc_bucket(decoded), T_buf)],
                       decoded - 1)
                if first is None:
                    # the first window's samples reach the host here
                    pending[-1][0] = pending[-1][0].cpu()
                    first = time.perf_counter() - t_start
            if on_chunk is None:
                # no consumer: no status read; rows past an EOS inside the
                # chunk are zeros, trimmed by the last flush
                continue
            done, n_now = self._status(state)
            flush(min(n_now if done else decoded, rendered))
            if done:
                break
        if not done:
            if decoded < budget:
                state = self._run(state, budget - decoded)
            bound = min(_pacing_bound(budget, pace_n, self.cfg.sampling),
                        T_buf)
            while rendered < bound - 1:
                end = min(rendered + VOC_CHUNK_SIZE, bound - 1)
                launch(state.codes[:, :min(voc.voc_bucket(end + 1), T_buf)],
                       end)
        n = int(state.n_codes[0])
        codes = state.codes[0, :n].cpu().numpy()
        while rendered < n:
            # past the bound (or the buffer): the lookahead row is a zero
            # code beyond the device buffer
            end = min(rendered + VOC_CHUNK_SIZE, n)
            launch(voc.pad_window(codes, voc.voc_bucket(end + 1),
                                  self.device), end)
        flush(n)
        audio = (np.concatenate(chunks) if chunks
                 else np.zeros((0,), np.int16))
        return audio, n, codes, first

    def _stream(self, state, budget: int, pace_n: int, on_chunk,
                t_start: float):
        """Streaming on models/vocoder_stream ("incremental" mode): after
        each head chunk the stream is advanced over the chunk's new final
        frames in StreamStepper quanta, O(new tokens) wherever it sits;
        after the last decode call the steps up to the EOS-pacing bound,
        plus the zero-code frame that flushes the stream's lag of
        output_crop samples, are launched before the token count is read,
        and trimmed to it. The kept samples equal the non-streaming decode within the
        stream contract (+-1 LSB). The stream's position is a host int.
        ``pace_n``: the text tokens the decode paces EOS on (the target's
        alone for a cloned request). Returns (int16 audio, n, codes,
        first-audio seconds)."""
        stepper = self._stream_stepper
        stream = vstream.Stream()
        pending: List[vstream.Segment] = []
        chunks: List[np.ndarray] = []
        decoded = flushed = 0
        first = None

        def advance(end: int, final: bool) -> None:
            pending.extend(stepper.advance(self._vp, state.codes[0], stream,
                                           end, final))

        def flush(n_known: int) -> None:
            """Fetch the launched steps in order, trimming each to the
            known token count, and hand each piece to on_chunk."""
            nonlocal flushed, first
            while flushed < len(pending):
                a = pending[flushed].take(n_known)
                flushed += 1
                if not len(a):
                    continue
                chunks.append(a)
                if first is None:
                    first = time.perf_counter() - t_start
                if on_chunk is not None:
                    on_chunk(a)

        done = False
        for ci, step_budget in enumerate(self.head_schedule):
            step_budget = min(step_budget, budget - decoded)
            if step_budget <= 0:
                break
            if ci > 0:
                state = self._run(state, step_budget)
            decoded += step_budget
            if on_chunk is None:
                # no consumer: no status read; frames past an EOS inside
                # the chunk are zeros, trimmed by the last flush
                advance(decoded, False)
                if first is None and pending:
                    pending[0].fetch()
                    first = time.perf_counter() - t_start
                continue
            done, n_now = self._status(state)
            end = n_now if done else decoded
            advance(end, done)
            flush(end)
            if done:
                break
        if not done:
            if decoded < budget:
                state = self._run(state, budget - decoded)
            # every possibly final frame, launched before the token count
            # is read; the overshoot is trimmed
            advance(min(_pacing_bound(budget, pace_n, self.cfg.sampling),
                        int(state.codes.shape[1])), True)
        n = int(state.n_codes[0])
        codes = state.codes[0, :n].cpu().numpy()
        advance(n, True)       # launches nothing unless n passed the bound
        flush(n)
        audio = (np.concatenate(chunks) if chunks
                 else np.zeros((0,), np.int16))
        return audio, n, codes, first

    @torch.inference_mode()
    def synthesize_batch(self, texts, languages=None, seed: int = 0,
                         max_tokens: Optional[int] = None):
        """Several texts in ONE batched decode: every text is padded to
        the largest bucket, one batched prefix and prefill, one batched
        loop, then each row is vocoded through voc.synthesize_exact. Row
        i draws with key batch_keys(seed, B)[i] (row 0 as
        synthesize(seed=seed)).
        ``max_tokens`` caps every row. Returns one SynthesisResult per
        text, sharing the timing fields."""
        if not len(texts):
            return []
        languages = languages or ["russian"] * len(texts)
        for lang in languages:
            if lang not in SUPPORTED_LANGUAGES:
                raise ValueError(f"unsupported language {lang!r}")
        if max_tokens is not None and max_tokens < 1:
            raise ValueError(f"max_tokens must be >= 1, got {max_tokens}")
        budget = (min(int(max_tokens), self.cfg.max_tokens)
                  if max_tokens is not None else self.cfg.max_tokens)
        B = len(texts)
        timings: Dict[str, float] = {}
        t_start = time.perf_counter()
        with _stage(timings, "tokenize"):
            encoded = [self._encode_text(t) for t in texts]
            bucket = max(len(row) for row, _ in encoded)
            ids_np = np.zeros((B, bucket), np.int32)
            for i, (row, _) in enumerate(encoded):
                ids_np[i, :len(row)] = row
            ids = torch.from_numpy(ids_np).to(self.device)
            n_text = torch.tensor([n for _, n in encoded], dtype=torch.int32,
                                  device=self.device)
        with _stage(timings, "decode"):
            prefixes = [tk.build_prefix(self._tp, ids[i], encoded[i][1],
                                        self.mesh) for i in range(B)]
            prefix = torch.stack([p for p, _ in prefixes])
            plen = torch.stack([n for _, n in prefixes])
            state = gen.init_state(self._tp, prefix, plen, n_text,
                                   smp.batch_keys(seed, B), self.cfg,
                                   budget=budget, mesh=self.mesh)
            state = gen.run_steps(self._tp, self._cpp, state, self.cfg,
                                  budget, self.mesh)
            n_codes = state.n_codes.cpu().numpy()
            codes_all = state.codes.cpu().numpy()
        rows = []
        with _stage(timings, "vocoder"):
            for i in range(B):
                codes = codes_all[i, :int(n_codes[i])]
                rows.append((codes, self.vocode(codes)))
        total = time.perf_counter() - t_start
        results = []
        for codes, audio in rows:
            dur = len(audio) / SAMPLE_RATE
            results.append(SynthesisResult(
                audio_int16=audio, codes=codes, n_tokens=len(codes),
                timings=dict(timings), total_seconds=total,
                rtf=total / dur if dur > 0 else float("inf")))
        return results

    def synthesize_long(self, text: str, language: str = "russian",
                        seed: int = 0, output: Optional[str] = None,
                        max_batch: int = 4, on_chunk=None,
                        prompt_dir: Optional[str] = None,
                        max_tokens: Optional[int] = None) -> SynthesisResult:
        """Paragraph-length text. One request is bounded by
        ``cfg.max_tokens`` codec tokens, so the text splits into pieces
        whose encoded token count the decode covers
        (utils/text.split_for_budget against piece_token_budget). One
        piece goes to ``synthesize``. Otherwise the first piece decodes
        alone with ``seed`` (streamed when ``on_chunk`` is given, so the
        first audio comes after the head chunk), and the rest go in groups
        of ``max_batch`` through ``synthesize_batch(seed=seed + g)``, g the
        group's first piece (a group of one through ``synthesize``).
        ``prompt_dir`` applies to every piece; cloned pieces decode alone,
        piece j of group g with seed + g + j. ``on_chunk(audio_int16)``
        gets the audio in order: the first piece in stream pieces, each
        later piece whole. ``max_tokens`` caps every piece (and tightens
        the split). Returns one SynthesisResult of the stitched audio and
        codes."""
        if language not in SUPPORTED_LANGUAGES:
            raise ValueError(f"unsupported language {language!r}; expected "
                             f"one of {SUPPORTED_LANGUAGES}")
        if max_tokens is not None and max_tokens < 1:
            raise ValueError(f"max_tokens must be >= 1, got {max_tokens}")
        budget = piece_token_budget(self.cfg.max_tokens, max_tokens)
        if prompt_dir is not None:
            # every cloned piece carries the reference transcript
            budget = self._cloned_piece_budget(
                budget, self._load_prompt(prompt_dir)[1])
        pieces = split_for_budget(
            text, lambda s: len(self.tokenizer.encode(
                s, add_special_tokens=False)), budget)
        if len(pieces) <= 1:
            return self.synthesize(text, language=language, seed=seed,
                                   output=output, prompt_dir=prompt_dir,
                                   max_tokens=max_tokens,
                                   streaming=on_chunk is not None,
                                   on_chunk=on_chunk)

        t_start = time.perf_counter()
        first: Optional[float] = None
        audio_parts: List[np.ndarray] = []
        codes_parts: List[np.ndarray] = []

        def emit(a16: np.ndarray) -> None:
            nonlocal first
            if not len(a16):
                return
            if first is None:
                first = time.perf_counter() - t_start
            if on_chunk is not None:
                on_chunk(a16)

        start = 0
        if prompt_dir is None:
            # the first piece decodes alone in both modes (its stream is
            # its non-streaming decode within +-1 LSB, its codes equal)
            r0 = self.synthesize(pieces[0], language=language, seed=seed,
                                 streaming=on_chunk is not None,
                                 max_tokens=max_tokens,
                                 on_chunk=emit if on_chunk is not None
                                 else None)
            codes_parts.append(r0.codes)
            audio_parts.append(r0.audio_int16)
            if on_chunk is None:
                emit(r0.audio_int16)    # stamps the first audio
            start = 1
        for g in range(start, len(pieces), max_batch):
            group = pieces[g:g + max_batch]
            if prompt_dir is not None:
                rs = [self.synthesize(p, language=language, seed=seed + g + j,
                                      prompt_dir=prompt_dir,
                                      max_tokens=max_tokens)
                      for j, p in enumerate(group)]
            elif len(group) == 1:
                rs = [self.synthesize(group[0], language=language,
                                      seed=seed + g, max_tokens=max_tokens)]
            else:
                rs = self.synthesize_batch(group, [language] * len(group),
                                           seed=seed + g,
                                           max_tokens=max_tokens)
            for r in rs:
                codes_parts.append(r.codes)
                audio_parts.append(r.audio_int16)
                emit(r.audio_int16)

        audio = np.concatenate(audio_parts)
        codes = np.concatenate(codes_parts)
        total = time.perf_counter() - t_start
        seconds = len(audio) / SAMPLE_RATE
        if output and len(audio):
            wav_io.write_wav(output, audio)
        return SynthesisResult(
            audio_int16=audio, codes=codes, n_tokens=len(codes),
            timings={"total": total}, total_seconds=total,
            rtf=total / seconds if seconds > 0 else float("inf"),
            first_audio_seconds=first)
