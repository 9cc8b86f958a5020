"""Checkpoint I/O of the port against the JAX package, on the CPU at
tiny geometry, with numpy-seeded weights:

- the safetensors reader (io/safetensors.py) against the ``safetensors``
  package and JAX's reader: every dtype, bf16 kept bf16, the same refusals;
- ``load_params`` on one synthetic HF directory (``model.safetensors``
  and ``speech_tokenizer/``, written by ``safetensors.numpy.save_file``
  from chip_smoke.py's inverse mapping) gives JAX's trees exactly, and
  the original weights: bf16 and the f32 vocoder and encoder bit for bit;
- ``detect_tts_config`` equals JAX's at a non-default geometry and with
  stacks of one depth (config.json's scalars by key path);
- the strict vocoder and encoder loaders raise on a missing or an extra
  tensor in both packages; a directory without a speech tokenizer warns;
- params.npz both ways (port -> JAX, JAX -> port) for bf16, int8 and
  int8-cp trees and the embedded config;
- read_wav and the config's encoder and keys equal JAX's.
"""

import dataclasses
import json
import os
import shutil
import warnings

import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file, save_file

import jax
import jax.numpy as jnp

import chip_smoke
from qwen3_tts_tpu import config as C
from qwen3_tts_tpu.io import wav as jwav
from qwen3_tts_tpu.io import weights as jweights
from qwen3_tts_tpu.models import encoder as jenc
from qwen3_tts_tpu.ops import quant as jquant
from qwen3_tts_tpu.runtime import native as jnative
from qwen3_tts_tpu_torch import config as pconfig
from qwen3_tts_tpu_torch.io import safetensors as tst
from qwen3_tts_tpu_torch.io import wav as twav
from qwen3_tts_tpu_torch.io import weights as tweights
from qwen3_tts_tpu_torch.models import encoder as tenc
from qwen3_tts_tpu_torch.ops import quant as tquant

torch.set_num_threads(1)

JCFG = C.tiny_tts_config(max_tokens=8)
PCFG = pconfig.tiny_tts_config(max_tokens=8)


def _np(tree):
    """JAX params -> numpy, each QTensor as (q, scale)."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items() if k != "layers_list"}
    if isinstance(tree, jquant.QTensor):
        return (np.asarray(tree.q), np.asarray(tree.scale))
    return np.asarray(tree)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy, bf16 as ml_dtypes' bfloat16 (same bits)."""
    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def assert_trees_equal(got, want, path=""):
    """A port tree against a numpy one (from _np), bit for bit: the same
    keys, dtypes and values; QTensors as (q, scale)."""
    if isinstance(want, dict):
        assert set(k for k in got if k != "layers_list") == set(want), path
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, tuple):
        assert isinstance(got, tquant.QTensor), path
        assert_trees_equal(got.q, want[0], path + "::q8")
        assert_trees_equal(got.scale, want[1], path + "::q8s")
    else:
        g = _to_numpy(got)
        assert g.dtype == want.dtype, (path, g.dtype, want.dtype)
        assert g.shape == want.shape, (path, g.shape, want.shape)
        np.testing.assert_array_equal(g.view(np.uint8), np.ascontiguousarray(
            want).view(np.uint8), err_msg=path)


def write_hf_dir(d, params, enc_params, config_json=None):
    """An HF-named checkpoint directory from port trees, written with the
    safetensors package."""
    d = str(d)
    os.makedirs(os.path.join(d, "speech_tokenizer"), exist_ok=True)
    save_file({k: _to_numpy(v)
               for k, v in chip_smoke.hf_state_dict(params).items()},
              os.path.join(d, "model.safetensors"))
    st = {"decoder." + k: _to_numpy(v) for k, v in
          chip_smoke.vocoder_state_dict(params["vocoder"]).items()}
    if enc_params is not None:
        st.update({"encoder." + k: _to_numpy(v) for k, v in
                   chip_smoke.encoder_state_dict(enc_params).items()})
    save_file(st, os.path.join(d, "speech_tokenizer", "model.safetensors"))
    if config_json is not None:
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(config_json, f)
    return d


@pytest.fixture(scope="module")
def trees():
    """Seeded JAX weights (bf16 talker and code predictor, f32 vocoder and
    encoder) as numpy, and the same as port trees."""
    jp = jweights.init_random_params(JCFG, seed=3, dtype=jnp.bfloat16)
    jp = dict(jp, encoder=jenc.init_encoder_params(jax.random.PRNGKey(5),
                                                   JCFG.encoder))
    npt = _np(jp)
    return npt, tweights.from_jax_numpy(npt)


@pytest.fixture(scope="module")
def hf_dir(trees, tmp_path_factory):
    _, tp = trees
    return write_hf_dir(tmp_path_factory.mktemp("hf"), tp, tp["encoder"])


# ---------------------------------------------------------------------------
# the safetensors reader
# ---------------------------------------------------------------------------

def test_reader_reads_every_dtype_as_the_library_does(tmp_path):
    rng = np.random.default_rng(0)
    arrays = {
        "f64": rng.normal(size=(3, 2)), "f32": rng.normal(size=(4,)).astype(
            np.float32),
        "f16": rng.normal(size=(2, 2)).astype(np.float16),
        "bf16": rng.normal(size=(5, 3)).astype(ml_dtypes.bfloat16),
        "i64": rng.integers(-9, 9, (3,)), "i32": rng.integers(
            -9, 9, (2, 2)).astype(np.int32),
        "i16": rng.integers(-9, 9, (2,)).astype(np.int16),
        "i8": rng.integers(-9, 9, (6,)).astype(np.int8),
        "u8": rng.integers(0, 9, (6,)).astype(np.uint8),
        "u16": rng.integers(0, 9, (2,)).astype(np.uint16),
        "b": rng.integers(0, 2, (3,)).astype(bool),
        "scalar": np.array(2.5, np.float32),
    }
    path = str(tmp_path / "x.safetensors")
    save_file(arrays, path)
    got = tst.read_safetensors(path)
    assert set(got) == set(arrays)
    assert got["bf16"].dtype == torch.bfloat16    # never upcast
    for k, a in arrays.items():
        g = _to_numpy(got[k]) if k != "u16" else got[k].view(
            torch.int16).numpy().view(np.uint16)
        assert g.dtype == a.dtype and g.shape == a.shape, k
        np.testing.assert_array_equal(g, a, err_msg=k)
    assert tst.list_safetensors_keys(path) == \
        jweights.list_safetensors_keys(path)
    # JAX's pure-Python reader (the one the port copies) upcasts bf16 to
    # f32: the same values
    py = jnative._PySafetensors(path)
    for k in arrays:
        np.testing.assert_array_equal(got[k].float().numpy()
                                      if k == "bf16" else _to_numpy(got[k])
                                      if k != "u16" else arrays[k],
                                      py.tensor(k), err_msg=k)


def test_reader_refuses_what_jax_refuses(tmp_path):
    """An F8 tensor (a dtype outside the set of JAX's pure-Python reader,
    which the port copies) raises ValueError in both; a byte range that
    does not fit the shape raises in the port."""
    hdr = {"w": {"dtype": "F8_E4M3", "shape": [4], "data_offsets": [0, 4]}}
    path = tmp_path / "f8.safetensors"
    hb = json.dumps(hdr).encode()
    path.write_bytes(len(hb).to_bytes(8, "little") + hb + bytes(4))
    with pytest.raises(ValueError, match="unsupported"):
        tst.read_safetensors(str(path))
    with pytest.raises(ValueError):
        jnative._PySafetensors(str(path)).tensor("w")
    hdr = {"w": {"dtype": "F32", "shape": [4], "data_offsets": [0, 8]}}
    hb = json.dumps(hdr).encode()
    path.write_bytes(len(hb).to_bytes(8, "little") + hb + bytes(8))
    with pytest.raises(ValueError, match="byte range"):
        tst.read_safetensors(str(path))


def test_chip_smoke_writer_reads_back_in_the_library(trees, tmp_path):
    """chip_smoke.write_safetensors (the full-geometry phase's writer)
    writes what the safetensors package reads back, bf16 and f32."""
    _, tp = trees
    sd = dict(list(chip_smoke.hf_state_dict(tp).items())[:7])
    sd["f32"] = tp["vocoder"]["code_embedding"][:5]
    path = str(tmp_path / "w.safetensors")
    size = chip_smoke.write_safetensors(path, sd)
    assert size == os.path.getsize(path)
    back = load_file(path)
    assert set(back) == set(sd)
    for k, t in sd.items():
        np.testing.assert_array_equal(back[k], _to_numpy(t), err_msg=k)


# ---------------------------------------------------------------------------
# load_params on an HF directory
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_load_params_matches_jax_and_the_weights(trees, hf_dir, dtype):
    """Both packages' load_params on one HF directory give the same trees
    bit for bit, and those are the weights the directory was written from
    (chip_smoke's inverse mapping undone by JAX's loader)."""
    npt, _ = trees
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16"
                else (jnp.float32, torch.float32))
    want = _np(jweights.load_params(hf_dir, JCFG, jdt))
    got = tweights.load_params(hf_dir, PCFG, tdt)
    assert set(want) == set(got) == {"talker", "code_predictor", "vocoder",
                                     "encoder"}
    assert_trees_equal(got, want)
    for comp in ("vocoder", "encoder"):
        assert_trees_equal(got[comp], npt[comp], comp)
    if dtype == "bfloat16":
        for comp in ("talker", "code_predictor"):
            assert_trees_equal(got[comp], npt[comp], comp)


def test_missing_speech_tokenizer_warns_and_draws_a_vocoder(hf_dir, tmp_path):
    bare = tmp_path / "bare"
    bare.mkdir()
    shutil.copy(os.path.join(hf_dir, "model.safetensors"),
                bare / "model.safetensors")
    with pytest.warns(UserWarning, match="RANDOMLY INITIALIZED"):
        p = tweights.load_params(str(bare), PCFG, torch.float32, seed=1)
    with pytest.warns(UserWarning, match="RANDOMLY INITIALIZED"):
        jweights.load_params(str(bare), JCFG, jnp.float32)
    want = tweights.init_vocoder_params(PCFG.vocoder, seed=1)
    assert torch.equal(p["vocoder"]["out_w"], want["out_w"])
    assert "encoder" not in p


def test_speech_tokenizer_warns_on_groups_it_does_not_load(trees, tmp_path,
                                                           capfd):
    """Tensors outside decoder./encoder. are named on stderr by both."""
    _, tp = trees
    d = write_hf_dir(tmp_path / "x", tp, None)
    path = os.path.join(d, "speech_tokenizer", "model.safetensors")
    st = load_file(path)
    st["quantizer.codebook"] = np.zeros((2, 2), np.float32)
    save_file(st, path)
    out = tweights.load_speech_tokenizer(os.path.dirname(path), PCFG)
    assert set(out) == {"vocoder"}
    port_err = capfd.readouterr().err
    jweights.load_speech_tokenizer(os.path.dirname(path), JCFG)
    jax_err = capfd.readouterr().err
    assert "do not consume: ['<unprefixed>']" in port_err
    assert port_err == jax_err


def test_vocoder_npz_beside_the_checkpoint(trees, hf_dir, tmp_path):
    """Without speech_tokenizer/, vocoder.npz and encoder.npz (written by
    the port's convert_weights --speech_tokenizer) are loaded, in both
    packages."""
    from qwen3_tts_tpu_torch.tools import convert_weights
    npt, _ = trees
    d = tmp_path / "native_voc"
    d.mkdir()
    shutil.copy(os.path.join(hf_dir, "model.safetensors"),
                d / "model.safetensors")
    assert convert_weights.main(["--model_dir", hf_dir, "--speech_tokenizer",
                                 "--tiny", "--device", "cpu", "--output",
                                 str(d / "vocoder.npz")]) == 0
    assert (d / "encoder.npz").exists()
    got = tweights.load_params(str(d), PCFG)
    want = _np(jweights.load_params(str(d), JCFG))
    for comp in ("vocoder", "encoder"):
        assert_trees_equal(got[comp], npt[comp], comp)
        assert_trees_equal(got[comp], want[comp], comp)


# ---------------------------------------------------------------------------
# the strict loaders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("part", ["vocoder", "encoder"])
@pytest.mark.parametrize("fault", ["missing", "extra"])
def test_strict_loaders_refuse_in_both(trees, part, fault):
    _, tp = trees
    if part == "vocoder":
        sd = chip_smoke.vocoder_state_dict(tp["vocoder"])
        port = lambda s: tweights.load_vocoder_from_state_dict(  # noqa: E731
            s, PCFG.vocoder)
        jax_ = lambda s: jweights.load_vocoder_from_state_dict(  # noqa: E731
            s, JCFG.vocoder)
        drop = "decoder.0.conv.weight"
    else:
        sd = chip_smoke.encoder_state_dict(tp["encoder"])
        port = lambda s: tenc.load_encoder_from_state_dict(  # noqa: E731
            s, PCFG.encoder)
        jax_ = lambda s: jenc.load_encoder_from_state_dict(  # noqa: E731
            s, JCFG.encoder)
        drop = "encoder.0.conv.weight"
    sd = {k: v.numpy() for k, v in sd.items()}
    assert_trees_equal(port(sd), _np(jax_(sd)))
    if fault == "missing":
        del sd[drop]
        err = KeyError
    else:
        sd["bogus.weight"] = np.zeros((1,), np.float32)
        err = ValueError
    with pytest.raises(err):
        port(sd)
    with pytest.raises(err):
        jax_(sd)


# ---------------------------------------------------------------------------
# detect_tts_config and config_from_params
# ---------------------------------------------------------------------------

def _alt(cfg_mod, same_depth):
    talker = cfg_mod.TalkerConfig(
        num_layers=2 if same_depth else 3, hidden_size=48,
        intermediate_size=96, num_heads=6, num_kv_heads=3, head_dim=8,
        text_vocab_size=512, text_embed_dim=24, codec_vocab_size=3072,
        max_seq_len=64)
    cp = cfg_mod.CodePredictorConfig(
        num_layers=2, hidden_size=48, intermediate_size=96, num_heads=6,
        num_kv_heads=3, head_dim=8, num_groups=15, group_vocab_size=64,
        max_seq_len=16)
    return dataclasses.replace(cfg_mod.tiny_tts_config(max_tokens=4),
                               talker=talker, code_predictor=cp)


@pytest.mark.parametrize("same_depth", [False, True])
def test_detect_tts_config_matches_jax(tmp_path, same_depth):
    """A non-default geometry read from the header, eps and theta from
    config.json by key path (the talker's and the code predictor's even
    when their stacks have one depth and width), as JAX reads them; then
    config_from_params on the loaded trees."""
    alt = _alt(pconfig, same_depth)
    params = tweights.init_random_params(alt, seed=2, dtype=torch.bfloat16)
    d = tmp_path / "alt"
    d.mkdir()
    save_file({k: _to_numpy(v)
               for k, v in chip_smoke.hf_state_dict(params).items()},
              str(d / "model.safetensors"))
    (d / "config.json").write_text(json.dumps({
        "talker_config": {
            "num_hidden_layers": alt.talker.num_layers, "hidden_size": 48,
            "rms_norm_eps": 1e-5, "rope_theta": 500000.0,
            "code_predictor_config": {
                "num_hidden_layers": 2, "hidden_size": 48,
                "rms_norm_eps": 2e-5, "rope_theta": 10000.0}}}))
    got = tweights.detect_tts_config(str(d), base=pconfig.tiny_tts_config(4))
    want = jweights.detect_tts_config(str(d), base=C.tiny_tts_config(4))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.talker.num_layers, got.talker.num_heads,
            got.code_predictor.group_vocab_size) == (
                alt.talker.num_layers, 6, 64)
    assert (got.talker.rope_theta, got.code_predictor.rope_theta) == \
        (500000.0, 10000.0)
    assert (got.talker.rms_norm_eps, got.code_predictor.rms_norm_eps) == \
        (1e-5, 2e-5)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # no vocoder: drawn at random
        loaded = tweights.load_params(str(d), got)
        jloaded = jweights.load_params(str(d), want)
    assert dataclasses.asdict(tweights.config_from_params(loaded)) == \
        dataclasses.asdict(jweights.config_from_params(jloaded))
    assert dataclasses.asdict(tweights.config_from_params(
        dict(loaded, code_predictor=tquant.quantize_code_predictor(
            loaded["code_predictor"])))) == \
        dataclasses.asdict(jweights.config_from_params(dict(
            jloaded, code_predictor=jquant.quantize_code_predictor(
                jloaded["code_predictor"]))))


# ---------------------------------------------------------------------------
# params.npz both ways
# ---------------------------------------------------------------------------

def _jax_tree(kind):
    jp = jweights.init_random_params(JCFG, seed=4, dtype=jnp.bfloat16)
    if kind in ("int8", "int8-cp"):
        jp = dict(jp, code_predictor=jquant.quantize_code_predictor(
            jp["code_predictor"]))
    if kind == "int8":
        jp["talker"] = jquant.quantize_talker(jp["talker"])
    return jp


@pytest.mark.parametrize("kind", ["bf16", "int8", "int8-cp"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_params_npz_both_ways(tmp_path, kind, direction):
    """A params.npz written by one package loads in the other: the same
    tree bit for bit (bf16 through its uint16 bits, QTensors as int8 and
    f32 scales, no layers_list stored) and the same embedded config."""
    jp = _jax_tree(kind)
    npt = _np(jp)
    path = str(tmp_path / "params.npz")
    if direction == "jax_to_port":
        jweights.save_pytree_npz(path, jp, config=JCFG)
        got = tweights.load_pytree_npz(path)
        cfg = tweights.read_npz_config(path)
        assert cfg == PCFG
        assert_trees_equal(got, npt)
        for comp in ("talker", "code_predictor"):
            assert ("layers_list" in got[comp]) == tquant.is_quantized(
                got[comp])
    else:
        tweights.save_pytree_npz(path, tweights.from_jax_numpy(npt),
                                 config=PCFG)
        back = jweights.load_pytree_npz(path)
        assert jweights.read_npz_config(path) == JCFG
        assert_trees_equal(tweights.from_jax_numpy(_np(back)), npt)
    with np.load(path) as data:
        assert not any("layers_list" in k for k in data.files)
        assert any(k.endswith("::q8") for k in data.files) == (kind != "bf16")


def test_load_params_npz_casts_like_jax(tmp_path):
    """load_params on a params.npz dir: the talker and the code predictor
    cast to the dtype, QTensors and the vocoder kept, as JAX's."""
    jp = _jax_tree("int8-cp")
    jweights.save_pytree_npz(str(tmp_path / "params.npz"), jp, config=JCFG)
    got = tweights.load_params(str(tmp_path), PCFG, torch.float32)
    want = _np(jweights.load_params(str(tmp_path), JCFG, jnp.float32))
    assert_trees_equal(got, want)
    assert got["talker"]["codec_head"].dtype == torch.float32
    assert isinstance(got["code_predictor"]["lm_heads"], tquant.QTensor)


# ---------------------------------------------------------------------------
# wav and config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width,channels", [(2, 1), (2, 2), (4, 1)])
def test_read_wav_matches_jax(tmp_path, width, channels):
    import wave
    rng = np.random.default_rng(width * 10 + channels)
    dt = np.int16 if width == 2 else np.int32
    info = np.iinfo(dt)
    frames = rng.integers(info.min, info.max, (300, channels)).astype(dt)
    path = str(tmp_path / "x.wav")
    with wave.open(path, "w") as wf:
        wf.setnchannels(channels)
        wf.setsampwidth(width)
        wf.setframerate(16000)
        wf.writeframes(frames.tobytes())
    got, sr = twav.read_wav(path)
    want, jsr = jwav.read_wav(path)
    assert sr == jsr == 16000
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_encoder_config_and_keys_match_jax():
    """EncoderConfig's fields, head_dim and total_downsample (1920) equal
    JAX's in both geometries, and asdict(TTSConfig) has JAX's keys in
    JAX's order, which a params.npz embeds."""
    for jcfg, pcfg in ((C.TTSConfig(), pconfig.TTSConfig()),
                       (C.tiny_tts_config(8), pconfig.tiny_tts_config(8))):
        assert dataclasses.asdict(pcfg.encoder) == \
            dataclasses.asdict(jcfg.encoder)
        assert pcfg.encoder.total_downsample == \
            jcfg.encoder.total_downsample == 1920
        assert pcfg.encoder.head_dim == jcfg.encoder.head_dim
        assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
        assert list(dataclasses.asdict(pcfg)) == \
            list(dataclasses.asdict(jcfg))
