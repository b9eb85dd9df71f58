"""The port's CUDA kernels against their plain versions, on the card.

Skipped without CUDA (the ``cuda`` marker).  Runs where no JAX is installed,
so it imports only torch and the port; on a machine with a card:

    python -m pytest tests/test_torch_port_cuda.py -q --noconftest

(``--noconftest``: tests/conftest.py sets up JAX for the CPU suite.)

Tolerances.  Kernel and plain version round at the same points; only the
order of fp32 sums differs, which moves a rounded value by at most one ulp
where it sits on a boundary.  So bf16 outputs agree to two bf16 ulps of the
output's largest magnitude (2 * 2**-8 relative), fp32 router logits to
2e-3 of their largest magnitude, and a hard gate may differ only where its
logit lies within that tolerance of 0.
"""

import pytest
import torch

from dynamic_tuning_tpu_torch.ops import mha_serving as ms

pytestmark = pytest.mark.cuda
BF = torch.bfloat16


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def make_inputs(B, N, C, F, *, xdtype=BF, seed=0, router_scale=25.0):
    """Kernel arguments at ViT-like weight scales, from a seeded generator on
    the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape, s=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=g, device="cuda") * s).to(dtype)

    sub = (r(C, s=0.05) + 1.0, r(C, s=0.02), r(3 * C, C, s=0.03, dtype=BF),
           r(3 * C, s=0.02), r(C, C, s=0.03, dtype=BF), r(C, s=0.02))
    ad = (r(F, C, s=0.03, dtype=BF), r(F, s=0.02), r(C, F, s=0.02, dtype=BF),
          r(C, s=0.01), torch.full((1,), 0.1, device="cuda"),
          r(1, C, s=router_scale / C ** 0.5), r(1, s=0.1))
    return r(B, N, C, dtype=xdtype), sub, ad


def bf16_close(got, want, what=""):
    tol = 2 * 2.0 ** -8 * want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, f"{what}: max |err| {err} > {tol}"
    return err


def logits_close(got, want):
    tol = 2e-3 * want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= tol, f"logits: max |err| {err} > {tol}"
    sure = want.abs() > tol
    assert torch.equal((got > 0)[sure], (want > 0)[sure]), "gate flipped"
    return err


SHAPES = [(128, 197, 768, 12, 64),      # ViT-B/16 serving
          (3, 19, 128, 2, 16),          # ragged rows and tokens
          (2, 197, 256, 2, 32)]         # head_dim 128


@pytest.mark.parametrize("xdtype", [BF, torch.float32])
@pytest.mark.parametrize("B,N,C,H,F", SHAPES)
def test_attention_sublayer_kernel(B, N, C, H, F, xdtype):
    x, sub, _ = make_inputs(B, N, C, F, xdtype=xdtype)
    before = ms.attention_sublayer_serving.launches
    got = ms.attention_sublayer_serving(x, *sub, heads=H)
    torch.cuda.synchronize()
    assert ms.attention_sublayer_serving.launches == before + 1
    want = ms.attention_sublayer_plain(x, *sub, heads=H)
    assert got.dtype == xdtype and got.shape == x.shape
    bf16_close(got, want, "x_mid")


@pytest.mark.parametrize("with_select", [True, False])
@pytest.mark.parametrize("B,N,C,H,F", SHAPES)
def test_dyt_prologue_kernel(B, N, C, H, F, with_select):
    x, sub, ad = make_inputs(B, N, C, F, seed=1)
    before = ms.dyt_prologue_serving.launches
    got = ms.dyt_prologue_serving(x, *sub, *ad, heads=H,
                                  with_select=with_select)
    torch.cuda.synchronize()
    assert ms.dyt_prologue_serving.launches == before + 1
    want = ms.dyt_prologue_plain(x, *sub, *ad, heads=H,
                                 with_select=with_select)
    assert len(got) == (3 if with_select else 2)
    bf16_close(got[0], want[0], "x_mid")
    bf16_close(got[1], want[1], "adapt")
    if with_select:
        logits_close(got[2], want[2])


def test_attention_core_clamps_large_scores():
    x, sub, _ = make_inputs(2, 197, 768, 64, seed=2)
    wqkv = sub[2].float()
    wqkv[:2 * 768] *= 30.0                         # scores far past 80
    sub = sub[:2] + (wqkv.to(BF),) + sub[3:]
    got = ms.attention_sublayer_serving(x, *sub, heads=12)
    assert torch.isfinite(got.float()).all()


def test_wrappers_raise_on_unsupported_input():
    x, sub, ad = make_inputs(2, 19, 128, 16)
    with pytest.raises(TypeError):                  # fp32 weights
        ms.attention_sublayer_serving(x, sub[0], sub[1], sub[2].float(),
                                      *sub[3:], heads=2)
    with pytest.raises(ValueError, match="contiguous"):
        ms.attention_sublayer_serving(x.transpose(0, 1).contiguous()
                                      .transpose(0, 1), *sub, heads=2)
    with pytest.raises(ValueError, match="head_dim"):
        ms.attention_sublayer_serving(x, *sub, heads=4)     # hd = 32
    with pytest.raises(ValueError, match="adapter width"):
        x2, sub2, ad2 = make_inputs(2, 19, 128, 8)
        ms.dyt_prologue_serving(x2, *sub2, *ad2, heads=2)
