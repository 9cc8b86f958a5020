"""The port's CUDA kernels against their plain PyTorch versions, on the
card, at small shapes. Each plain version adds up in its kernel's order,
so kernel and plain version must agree bit for bit.

Every test skips where there is no CUDA device. The file imports no jax,
so it also runs on a GPU machine without it (the suite's conftest.py
imports jax, hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from qwen3_tts_tpu_torch.models import transformer as tfm
from qwen3_tts_tpu_torch.ops import quant
from qwen3_tts_tpu_torch.ops.kernels import cp_decode as tcp
from qwen3_tts_tpu_torch.ops.kernels import qmatmul as tqm
from qwen3_tts_tpu_torch.ops.kernels import talker_step as tts

pytestmark = pytest.mark.cuda

# talker-step geometry of tests/test_talker_kernel.py
TGEO = tfm.TransformerGeometry(
    num_layers=2, hidden_size=256, intermediate_size=256, num_heads=2,
    num_kv_heads=1, head_dim=128, rms_norm_eps=1e-6, rope_theta=1e6)
# a small code predictor: H=64, Dh=16, 2 layers, full 2048-code groups
CGEO = tfm.TransformerGeometry(
    num_layers=2, hidden_size=64, intermediate_size=128, num_heads=4,
    num_kv_heads=2, head_dim=16, rms_norm_eps=1e-6, rope_theta=1e6)
CP_GROUPS, CP_VOCAB, CP_S = 15, 2048, 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                    "mode; tests/test_torch_kernels.py holds their plain "
                    "versions to the JAX kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _stack(rng, geo, dev, scale=0.02):
    """A float32 layer stack (JAX init shapes) on ``dev``."""
    L, H, I = geo.num_layers, geo.hidden_size, geo.intermediate_size
    QD, KVD = geo.num_heads * geo.head_dim, geo.num_kv_heads * geo.head_dim

    def w(*shape):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    def norm(*shape):
        return torch.from_numpy((1.0 + 0.1 * rng.standard_normal(shape))
                                .astype(np.float32)).to(dev)

    return {"input_ln": norm(L, H), "post_ln": norm(L, H),
            "q_norm": norm(L, geo.head_dim), "k_norm": norm(L, geo.head_dim),
            "q_proj": w(L, H, QD), "k_proj": w(L, H, KVD),
            "v_proj": w(L, H, KVD), "o_proj": w(L, QD, H),
            "gate_proj": w(L, H, I), "up_proj": w(L, H, I),
            "down_proj": w(L, I, H)}


@pytest.mark.parametrize("M", [1, 2, 73])
def test_qmatmul_kernel_matches_plain(cuda, M):
    g = torch.Generator(device=cuda).manual_seed(M)
    x = torch.randn((M, 1024), generator=g, device=cuda).bfloat16()
    q = torch.randint(-127, 128, (1024, 3072), generator=g, device=cuda,
                      dtype=torch.int8)
    s = torch.rand((3072,), generator=g, device=cuda) * 0.01 + 1e-3
    torch.testing.assert_close(tqm.qmatmul(x, q, s),
                               tqm.qmatmul_plain(x, q, s), rtol=0, atol=0)


@pytest.mark.parametrize("B", [1, 3])
def test_talker_step_kernel_matches_plain(cuda, B):
    rng = np.random.default_rng(B)
    layers = quant.quantize_layer_stack(_stack(rng, TGEO, cuda), fuse=True)
    g = torch.Generator(device=cuda).manual_seed(B)
    x = torch.randn((B, TGEO.hidden_size), generator=g,
                    device=cuda).bfloat16()
    kv = torch.randn((TGEO.num_layers, 2, B, 64, 1, TGEO.head_dim),
                     generator=g, device=cuda).bfloat16()
    pos = torch.randint(1, 63, (B,), generator=g, device=cuda)
    cos, sin = tfm.rope_cos_sin(torch.arange(64, device=cuda),
                                TGEO.head_dim, TGEO.rope_theta)
    h_k, r_k = tts.talker_step_cuda(layers, x, pos, kv, cos, sin, 1e-6)
    h_p, r_p = tts.talker_step_plain(layers, x, pos, kv, cos, sin, 1e-6)
    torch.testing.assert_close(h_k, h_p, rtol=0, atol=0)
    torch.testing.assert_close(r_k, r_p, rtol=0, atol=0)


@pytest.mark.parametrize("greedy", [True, False])
def test_cp_decode_kernel_matches_plain(cuda, greedy):
    rng = np.random.default_rng(1)
    B, H = 3, CGEO.hidden_size

    def w(*shape, scale=0.02):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)).to(cuda)

    params = quant.quantize_code_predictor({
        "layers": _stack(rng, CGEO, cuda),
        "final_norm": torch.ones((H,), device=cuda),
        "mtp_proj_w": w(H, H), "mtp_proj_b": w(H),
        "codec_embs": w(CP_GROUPS, CP_VOCAB, H),
        "lm_heads": w(CP_GROUPS, H, CP_VOCAB, scale=0.2)})
    kv = torch.zeros((CGEO.num_layers, 2, B, CP_S, CGEO.num_kv_heads,
                      CGEO.head_dim), device=cuda)
    kv[:, :, :, :2] = w(*kv[:, :, :, :2].shape, scale=0.5)
    tok0 = torch.from_numpy(rng.integers(0, CP_VOCAB, (B,))
                            .astype(np.int32)).to(cuda)
    seeds = torch.arange(B, dtype=torch.int32, device=cuda) * 7919 + 11
    cos, sin = tfm.rope_cos_sin(torch.arange(CP_S, device=cuda),
                                CGEO.head_dim, CGEO.rope_theta)
    kw = dict(eps=CGEO.rms_norm_eps, top_k=50,
              temperature=0.0 if greedy else 0.1, greedy=greedy)
    args = (params, tok0, kv, cos, sin, seeds)
    torch.testing.assert_close(tcp.cp_decode_cuda(*args, **kw),
                               tcp.cp_decode_plain(*args, **kw), rtol=0,
                               atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_matches_plain(cuda, dtype):
    from qwen3_tts_tpu_torch.ops.kernels import decode_attention as tda
    g = torch.Generator(device=cuda).manual_seed(3)
    B, Hq, Hkv, Dh, S = 3, 8, 4, 64, 80
    q = torch.randn((B, Hq, Dh), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, S, Hkv, Dh), generator=g, device=cuda).to(dtype)
    v = torch.randn((B, S, Hkv, Dh), generator=g, device=cuda).to(dtype)
    pos = torch.tensor([0, S - 1, 33], device=cuda)
    torch.testing.assert_close(tda.decode_attention_cuda(q, k, v, pos),
                               tda.decode_attention_plain(q, k, v, pos),
                               rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel_matches_plain(cuda, dtype):
    from qwen3_tts_tpu_torch.ops.kernels import paged_attention as tpa
    g = torch.Generator(device=cuda).manual_seed(4)
    B, Hq, Hkv, Dh, P, psz, MAXP = 3, 8, 4, 64, 20, 16, 5
    q = torch.randn((B, Hq, Dh), generator=g, device=cuda).to(dtype)
    pool = torch.randn((2, P, psz, Hkv, Dh), generator=g,
                       device=cuda).to(dtype)
    perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(0))
    table = (perm[:B * MAXP] + 1).reshape(B, MAXP).to(torch.int32).to(cuda)
    table[0, 2:] = 0
    pos = torch.tensor([20, MAXP * psz - 1, 47], device=cuda)
    torch.testing.assert_close(
        tpa.paged_attention_cuda(q, pool[0], pool[1], table, pos),
        tpa.paged_attention_plain(q, pool[0], pool[1], table, pos),
        rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kv_int8_kernel_matches_plain(cuda, dtype):
    from qwen3_tts_tpu_torch.ops.kernels import kv_int8 as tkv
    g = torch.Generator(device=cuda).manual_seed(5)
    B, Hq, Hkv, Dh, S = 3, 8, 4, 64, 80
    q = torch.randn((B, Hq, Dh), generator=g, device=cuda).to(dtype)
    kq, ks = tkv.quantize_kv_rows(
        torch.randn((B, Hkv, S, Dh), generator=g, device=cuda))
    vq, vs = tkv.quantize_kv_rows(
        torch.randn((B, Hkv, S, Dh), generator=g, device=cuda))
    pos = torch.tensor([0, S - 1, 33], device=cuda)
    args = (q, kq, ks, vq, vs, pos)
    torch.testing.assert_close(tkv.decode_attention_kv_int8_cuda(*args),
                               tkv.decode_attention_kv_int8_plain(*args),
                               rtol=0, atol=0)


@pytest.mark.parametrize("vec_merged", [False, True])
def test_talker_merged_kernel_matches_plain_and_k3(cuda, vec_merged):
    """K7 (merged weight streams, the qmm tile reading column blocks with
    a row stride ldw != N) against its plain version and against K3 on
    the same weights, bit for bit."""
    from qwen3_tts_tpu_torch.ops.kernels import talker_merged as tm
    B = 3
    rng = np.random.default_rng(B)
    layers = tm.with_merged(
        quant.quantize_layer_stack(_stack(rng, TGEO, cuda), fuse=True))
    g = torch.Generator(device=cuda).manual_seed(B)
    x = torch.randn((B, TGEO.hidden_size), generator=g,
                    device=cuda).bfloat16()
    kv = torch.randn((TGEO.num_layers, 2, B, 64, 1, TGEO.head_dim),
                     generator=g, device=cuda).bfloat16()
    pos = torch.randint(1, 63, (B,), generator=g, device=cuda)
    cos, sin = tfm.rope_cos_sin(torch.arange(64, device=cuda),
                                TGEO.head_dim, TGEO.rope_theta)
    args = (layers, x, pos, kv, cos, sin, 1e-6, vec_merged)
    h_k, r_k = tm.talker_merged_cuda(*args)
    h_p, r_p = tm.talker_merged_plain(*args)
    h_3, r_3 = tts.talker_step_cuda(layers, x, pos, kv, cos, sin, 1e-6)
    for a, b in ((h_k, h_p), (r_k, r_p), (h_k, h_3), (r_k, r_3)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
