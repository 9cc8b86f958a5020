"""Per-row draws and TTSEngine.synthesize_batch of the port, on the CPU at
tiny geometry.

1. A row's sampled codes do not depend on the rest of the batch: at
   temperature > 0, row k of a B = 3 decode equals a B = 1 decode with the
   same key, with the int8 code predictor on K2's plain version (B <= 8)
   and on the per-step path used past K2's batch limit.
2. synthesize_batch against the JAX engine's, f32 and greedy: three texts,
   codes bit-equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qwen3_tts_tpu import config as C
from qwen3_tts_tpu.engine import engine as jengine
from qwen3_tts_tpu.io import weights as jweights
from qwen3_tts_tpu_torch import config as pconfig
from qwen3_tts_tpu_torch.engine import engine as tengine
from qwen3_tts_tpu_torch.engine import generate as tgen
from qwen3_tts_tpu_torch.io import weights as tweights
from qwen3_tts_tpu_torch.models import code_predictor as tcp
from qwen3_tts_tpu_torch.models import talker as ttk
from qwen3_tts_tpu_torch.ops import quant as tquant
from qwen3_tts_tpu_torch.ops import sampling as tsmp
from qwen3_tts_tpu_torch.ops.kernels import cp_decode as tcp_kernel

torch.set_num_threads(1)

TINY = pconfig.tiny_tts_config(max_tokens=8)
TEXTS = ["Привет, мир!", "Hello there.", "abc"]


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items() if k != "layers_list"}
    return np.asarray(tree)


@pytest.fixture(scope="module")
def int8_params():
    p = tweights.init_random_params(TINY, seed=0, dtype=torch.float32)
    p["code_predictor"] = tquant.quantize_code_predictor(
        p["code_predictor"])
    return p


def _decode(params, texts_ids, keys):
    tp, cpp = params["talker"], params["code_predictor"]
    pre = [ttk.build_prefix(tp, torch.from_numpy(ids), n)
           for ids, n in texts_ids]
    with torch.inference_mode():
        codes, n = tgen.generate(
            tp, cpp, torch.stack([p for p, _ in pre]),
            torch.stack([ln for _, ln in pre]),
            torch.tensor([n for _, n in texts_ids]), keys, TINY)
    return codes.numpy(), n.numpy()


@pytest.mark.parametrize("path", ["k2", "per_step"])
def test_row_codes_do_not_depend_on_the_batch(path, int8_params,
                                              monkeypatch):
    """Sampled (code_0 at 0.8, groups at 0.1): row 1 of a B = 3 decode
    equals the B = 1 decode with its key, through K2's plain version or
    through the per-step path (the gate forced off)."""
    calls = []
    real = tcp.cp_decode_steps
    monkeypatch.setattr(tcp, "cp_decode_steps",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    if path == "per_step":
        monkeypatch.setattr(tcp, "_fused_kernel_ok", lambda *a: False)
    rows = [(np.array([10 + 7 * i + j for j in range(6)], np.int32), 6)
            for i in range(3)]
    keys = tsmp.batch_keys([11, 22, 33], 3)
    codes3, n3 = _decode(int8_params, rows, keys)
    codes1, n1 = _decode(int8_params, rows[1:2], keys[1:2])
    assert bool(calls) == (path == "k2")
    assert n3[1] == n1[0] >= 2
    np.testing.assert_array_equal(codes3[1], codes1[0])
    # another key draws other codes
    codes1b, _ = _decode(int8_params, rows[1:2], tsmp.batch_keys([23], 1))
    assert not np.array_equal(codes1b[0], codes1[0])


def test_k2_and_per_step_paths_draw_the_same_noise():
    """Groups 2..15 draw with one per-row seed hashed with the step index
    on both paths: the same logits give the same tokens."""
    rng = np.random.default_rng(0)
    lg = torch.from_numpy(rng.standard_normal((3, 2048)).astype(np.float32))
    seeds = tsmp.as_int32(tsmp.draw_seeds(tsmp.batch_keys(5, 3),
                                          torch.arange(3),
                                          tsmp.SITE_CP_STEPS))
    a = tcp_kernel.sample_tokens(lg, seeds[:, None], 4, top_k=50,
                                 temperature=0.1, greedy=False)
    b = tcp_kernel.sample_tokens(lg[1:2], seeds[1:2, None], 4, top_k=50,
                                 temperature=0.1, greedy=False)
    assert int(a[1, 0]) == int(b[0, 0])
    assert tsmp.batch_keys(7, 3)[0] == 7
    assert len(set(tsmp.batch_keys(7, 3).tolist())) == 3


def test_synthesize_batch_matches_jax():
    """Three texts in one batched decode, f32, greedy: each row's codes
    bit-equal to the JAX engine's synthesize_batch, n * 1920 samples."""
    greedy = C.SamplingConfig(temperature=0.0, repetition_penalty=1.0,
                              cp_temperature=0.0)
    jcfg = dataclasses.replace(C.tiny_tts_config(max_tokens=8),
                               sampling=greedy)
    pcfg = dataclasses.replace(
        TINY, sampling=pconfig.SamplingConfig(**dataclasses.asdict(greedy)))
    jp = jweights.init_random_params(jcfg, seed=1, dtype=jnp.float32)
    tp = tweights.from_jax_numpy(_np(jp))
    want = jengine.TTSEngine(jcfg, params=jp, dtype=jnp.float32
                             ).synthesize_batch(TEXTS, seed=0)
    eng = tengine.TTSEngine(pcfg, params=tp, dtype=torch.float32,
                            device="cpu")
    got = eng.synthesize_batch(TEXTS, seed=0)
    assert len(got) == len(want) == 3
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.codes, np.asarray(w.codes))
        assert g.n_tokens == w.n_tokens
        assert len(g.audio_int16) == g.n_tokens * 1920
        assert g.audio_int16.dtype == np.int16
    assert eng.synthesize_batch([]) == []
    with pytest.raises(ValueError):
        eng.synthesize_batch(["a"], max_tokens=0)
    capped = eng.synthesize_batch(TEXTS, seed=0, max_tokens=2)
    assert all(r.n_tokens <= 2 for r in capped)
