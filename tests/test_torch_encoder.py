"""The port's speech-tokenizer encoder (models/encoder.py) against the
JAX package's, on the CPU at tiny geometry. The port's random init
cannot reproduce jax.random, so the JAX encoder's weights are carried
across (io/weights.from_jax_numpy):

- encode_features within f32 atol 1e-5 (convolutions add up in another
  order), rvq_encode's codes equal on the same latent, encode's equal
  end to end;
- RVQ recovers a latent built as the mean of codebook rows exactly;
  torch.argmin keeps the first index of a tie, as jnp.argmin;
- the strict loader round-trips through a mirror-named state dict
  (chip_smoke.encoder_state_dict) and agrees with JAX's on it;
- resample_linear and pad_to_tokens equal JAX's; init_encoder_params
  has JAX's tree and shapes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from qwen3_tts_tpu import config as C
from qwen3_tts_tpu.models import encoder as jenc
from qwen3_tts_tpu.models import vocoder as jvoc
from qwen3_tts_tpu_torch import config as pconfig
from qwen3_tts_tpu_torch.io import weights as tweights
from qwen3_tts_tpu_torch.models import encoder as tenc

torch.set_num_threads(1)

JCFG = C.tiny_tts_config()
PCFG = pconfig.tiny_tts_config()


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.fixture(scope="module")
def weights():
    """JAX's encoder and vocoder weights, as JAX arrays and as the port's
    tensors."""
    jp = {"encoder": jenc.init_encoder_params(jax.random.PRNGKey(3),
                                              JCFG.encoder),
          "vocoder": jvoc.init_vocoder_params(jax.random.PRNGKey(4),
                                              JCFG.vocoder)}
    return jp, tweights.from_jax_numpy(_np(jp))


def _wav(n_tokens, seed):
    return (np.random.default_rng(seed).normal(size=(1, 1920 * n_tokens))
            * 0.1).astype(np.float32)


@pytest.mark.parametrize("n_tokens", [1, 3, 5])
def test_encode_matches_jax(weights, n_tokens):
    jp, tp = weights
    wav = _wav(n_tokens, n_tokens)
    want = np.array(jenc.encode_features(jp["encoder"], jnp.asarray(wav),
                                           JCFG.encoder))
    got = tenc.encode_features(tp["encoder"], torch.from_numpy(wav),
                               PCFG.encoder).numpy()
    assert got.shape == want.shape == (1, n_tokens, PCFG.encoder.hidden_size)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    jcb = jenc.decoder_codebooks(jp["vocoder"], JCFG.vocoder)
    tcb = tenc.decoder_codebooks(tp["vocoder"], PCFG.vocoder)
    assert tcb.shape == (16, 2048, PCFG.vocoder.hidden_size)
    # the RVQ on one latent: equal codes
    jcodes = np.asarray(jenc.rvq_encode(jcb, jnp.asarray(want)))
    tcodes = tenc.rvq_encode(tcb, torch.from_numpy(want)).numpy()
    assert tcodes.dtype == np.int32
    np.testing.assert_array_equal(tcodes, jcodes)
    # end to end
    np.testing.assert_array_equal(
        tenc.encode(tp["encoder"], tcb, torch.from_numpy(wav),
                    PCFG.encoder).numpy(),
        np.asarray(jenc.encode(jp["encoder"], jcb, jnp.asarray(wav),
                               JCFG.encoder)))


def test_rvq_exact_recovery_and_first_index_ties():
    """A latent equal to the decoder's mean of codebook rows is recovered
    exactly with near-orthogonal codebooks (tests/test_encoder.py's case);
    with two equal rows the first index wins, in both packages."""
    D = 16
    rng = np.random.default_rng(0)
    cbs = np.zeros((2, 8, D), np.float32)
    cbs[0, :, :8] = rng.normal(size=(8, 8)) * 2
    cbs[1, :, 8:] = rng.normal(size=(8, 8)) * 2
    z = ((cbs[0, 3] + cbs[1, 5]) / 2)[None, None, :]
    codes = tenc.rvq_encode(torch.from_numpy(cbs), torch.from_numpy(z))
    assert codes[0, 0].tolist() == [3, 5]
    tie = cbs.copy()
    tie[0, 6] = tie[0, 3]
    got = tenc.rvq_encode(torch.from_numpy(tie), torch.from_numpy(z))
    want = np.asarray(jenc.rvq_encode(jnp.asarray(tie), jnp.asarray(z)))
    assert got[0, 0].tolist() == want[0, 0].tolist() == [3, 5]


def test_rvq_reduces_the_residual(weights):
    """Each stage's choice does not increase the residual, as JAX's test
    holds."""
    _, tp = weights
    cb = tenc.decoder_codebooks(tp["vocoder"], PCFG.vocoder)[:4]
    z = torch.from_numpy(np.random.default_rng(2).normal(
        size=(1, 6, cb.shape[-1])).astype(np.float32))
    codes = tenc.rvq_encode(cb, z)[0]
    target, resid = 4 * z[0], 4 * z[0]
    norms = [float(resid.norm())]
    for q in range(4):
        resid = resid - cb[q][codes[:, q].long()]
        norms.append(float(resid.norm()))
    assert all(b <= a + 1e-5 for a, b in zip(norms, norms[1:]))
    assert norms[-1] < float(target.norm())


def test_loader_round_trips_and_matches_jax(weights):
    jp, tp = weights
    sd = {k: v.numpy() for k, v in
          chip_smoke.encoder_state_dict(tp["encoder"]).items()}
    got = tenc.load_encoder_from_state_dict(sd, PCFG.encoder)
    want = jenc.load_encoder_from_state_dict(sd, JCFG.encoder)

    def same(a, b, j, path=""):
        if isinstance(b, dict):
            assert set(a) == set(b) == set(j), path
            for k in b:
                same(a[k], b[k], j[k], f"{path}/{k}")
        else:
            assert a.dtype == torch.float32, path
            assert torch.equal(a, b), path
            np.testing.assert_array_equal(a.numpy(), np.asarray(j),
                                          err_msg=path)

    same(got, tp["encoder"], want)
    # the 11 stacked transformer tensors are one tensor a layer there
    assert len(sd) == len(jax.tree.leaves(jp["encoder"])) + 11 * (
        PCFG.encoder.num_hidden_layers - 1)


@pytest.mark.parametrize("n,sr_in,sr_out", [
    (16000, 16000, 24000), (44100, 44100, 24000), (24000, 24000, 24000),
    (12345, 22050, 24000), (7, 8000, 24000)])
def test_audio_prep_matches_jax(n, sr_in, sr_out):
    wav = np.random.default_rng(n).normal(size=(n,)).astype(np.float32)
    got = tenc.resample_linear(wav, sr_in, sr_out)
    want = jenc.resample_linear(wav, sr_in, sr_out)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    padded = tenc.pad_to_tokens(got)
    np.testing.assert_array_equal(padded, jenc.pad_to_tokens(want))
    assert len(padded) % 1920 == 0 and len(padded) - len(got) < 1920


def test_init_has_jax_tree_and_shapes():
    got = tenc.init_encoder_params(PCFG.encoder, seed=0)
    want = jenc.init_encoder_params(jax.random.PRNGKey(0), JCFG.encoder)

    def shapes(a, b, path=""):
        if isinstance(b, dict):
            assert set(a) == set(b), path
            for k in b:
                shapes(a[k], b[k], f"{path}/{k}")
        else:
            assert tuple(a.shape) == tuple(b.shape), path
            assert a.dtype == torch.float32, path

    shapes(got, want)
    again = tenc.init_encoder_params(PCFG.encoder, seed=0)
    assert torch.equal(got["enc_in_w"], again["enc_in_w"])
    z = tenc.encode_features(got, torch.zeros(1, 1920 * 2), PCFG.encoder)
    assert z.shape == (1, 2, PCFG.encoder.hidden_size)
    assert torch.isfinite(z).all()
