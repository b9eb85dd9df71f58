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

import contextlib
from unittest import mock

import pytest
import torch

from dynamic_tuning_tpu_torch.ops import mha_serving as ms
from dynamic_tuning_tpu_torch.ops import quant as qt
from dynamic_tuning_tpu_torch.utils import kernel_diff as kd

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


@pytest.mark.parametrize("xdtype", [BF, torch.float32])
def test_attention_sublayer_kernel_fp32_copy(xdtype):
    """K2's chain with the fp32 copy of x_mid that K3 and K7 hand their
    adapter: the residual epilogue's two outputs."""
    x, sub, _ = make_inputs(3, 197, 768, 64, xdtype=xdtype, seed=3)
    lib = ms._check_sublayer(x, *sub, 12)
    xm32 = torch.empty(x.shape, dtype=torch.float32, device="cuda")
    got = ms._launch_sublayer(lib, x, *sub, 12, xm32)
    torch.cuda.synchronize()
    assert torch.equal(xm32.to(xdtype), got)
    bf16_close(xm32, ms._sublayer_f32(x, *sub, 12), "x_mid fp32")


def test_attention_core_clamps_large_scores():
    x, sub, _ = make_inputs(2, 197, 768, 64, seed=2)
    wqkv = sub[2].float()
    wqkv[:2 * 768] *= 30.0                         # scores far past 80
    sub = sub[:2] + (wqkv.to(BF),) + sub[3:]
    got = ms.attention_sublayer_serving(x, *sub, heads=12)
    assert torch.isfinite(got.float()).all()


# --- int8 (K4, K5, K6, K10 and the int8 stem) --------------------------------
#
# Tolerance.  The int8 kernels round at the plain versions' points and share
# their float64-summed LN and k means, but the bf16 attention core sums in
# another order, so a core output that sits on an int8 rounding boundary may
# take the neighbouring code; one activation code step moves an output by
# about |w| * amax / 127, a few 1e-3 of the output's range.  Every output,
# bf16 or fp32, is held to two bf16 ulps (2 * 2**-8) of its largest
# magnitude, router logits to 2e-3 of theirs.

def q8_sub(sub):
    g, b, wqkv, bqkv, wproj, bproj = sub
    return (g, b, *qt.quantize_weight(wqkv.float()), bqkv,
            *qt.quantize_weight(wproj.float()), bproj)


def mlp_q8_inputs(C, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s, sc=1.0: torch.randn(s, generator=g, device="cuda") * sc
    return (r(C, sc=0.05) + 1.0, r(C, sc=0.02),
            *qt.quantize_weight(r(4 * C, C, sc=0.03)), r(4 * C, sc=0.02),
            *qt.quantize_weight(r(C, 4 * C, sc=0.03)), r(C, sc=0.02))


@pytest.mark.parametrize("gelu_approx", [True, False], ids=["tanh", "erf"])
@pytest.mark.parametrize("xdtype", [BF, torch.float32])
@pytest.mark.parametrize("rows,C", [((128, 197), 768), ((128, 99), 768),
                                    ((3, 19), 128)])
def test_q8_ln_mlp_kernel(rows, C, xdtype, gelu_approx):
    x = torch.randn((*rows, C), device="cuda").to(xdtype)
    w = mlp_q8_inputs(C)
    before = qt.q8_ln_mlp.launches
    got = qt.q8_ln_mlp(x, *w, gelu_approx=gelu_approx)
    torch.cuda.synchronize()
    assert qt.q8_ln_mlp.launches == before + 1
    want = qt.q8_ln_mlp_plain(x, *w, gelu_approx=gelu_approx)
    assert got.dtype == xdtype and got.shape == x.shape
    bf16_close(got, want, "mlp")


@pytest.mark.parametrize("attn_q8", [False, True], ids=["core", "int8_attn"])
@pytest.mark.parametrize("xdtype", [BF, torch.float32])
@pytest.mark.parametrize("B,N,C,H,F", SHAPES)
def test_attention_sublayer_q8_kernel(B, N, C, H, F, xdtype, attn_q8):
    x, sub, _ = make_inputs(B, N, C, F, xdtype=xdtype, seed=3)
    before = (qt.attention_sublayer_serving_q8.launches,
              qt.attn_core_pairs_q8.launches)
    got = qt.attention_sublayer_serving_q8(x, *q8_sub(sub), heads=H,
                                           attn_q8=attn_q8)
    torch.cuda.synchronize()
    assert (qt.attention_sublayer_serving_q8.launches,
            qt.attn_core_pairs_q8.launches) == (before[0] + 1,
                                                before[1] + attn_q8)
    want = qt.attention_sublayer_q8_plain(x, *q8_sub(sub), heads=H,
                                          attn_q8=attn_q8)
    assert got.dtype == xdtype and got.shape == x.shape
    bf16_close(got, want, "x_mid")


@pytest.mark.parametrize("attn_q8", [False, True], ids=["core", "int8_attn"])
@pytest.mark.parametrize("with_select", [True, False])
@pytest.mark.parametrize("B,N,C,H,F", SHAPES)
def test_dyt_prologue_q8_kernel(B, N, C, H, F, with_select, attn_q8):
    x, sub, ad = make_inputs(B, N, C, F, seed=4)
    before = qt.dyt_prologue_serving_q8.launches
    got = qt.dyt_prologue_serving_q8(x, *q8_sub(sub), *ad, heads=H,
                                     with_select=with_select,
                                     attn_q8=attn_q8)
    torch.cuda.synchronize()
    assert qt.dyt_prologue_serving_q8.launches == before + 1
    want = qt.dyt_prologue_q8_plain(x, *q8_sub(sub), *ad, heads=H,
                                    with_select=with_select, attn_q8=attn_q8)
    assert len(got) == (3 if with_select else 2)
    bf16_close(got[0], want[0], "x_mid")
    bf16_close(got[1], want[1], "adapt")
    if with_select:
        logits_close(got[2], want[2])


@pytest.mark.parametrize("B,N,C,H", [(128, 197, 768, 12), (3, 19, 128, 2),
                                     (2, 197, 256, 2)])
def test_attn_core_q8_kernel(B, N, C, H):
    # serving-like scales: scores of order 1.  (With head 1's keys 10x head
    # 0's, one k code step moves a score by ~0.1 and the peaked softmax
    # passes that on; tests/test_torch_port_quant.py pins that case against
    # the JAX kernel.)
    g = torch.Generator(device="cuda").manual_seed(5)
    qkv = torch.randn((B, N, 3 * C), generator=g, device="cuda")
    qkv[..., C:2 * C] += 1.0                   # a common key offset
    qkv[..., C + C // H:C + 2 * C // H] *= 2.0    # head 1's keys 2x head 0's
    qkv = qkv.to(BF)
    before = qt.attn_core_pairs_q8.launches
    got = qt.attn_core_pairs_q8(qkv, heads=H)
    torch.cuda.synchronize()
    assert qt.attn_core_pairs_q8.launches == before + 1
    bf16_close(got, qt.attn_core_pairs_q8_plain(qkv, heads=H), "core")


@pytest.mark.parametrize("case", range(2 * (len(kd.CORE_Q8_N) + 2)))
def test_attn_core_q8_kernel_across_n(case):
    """K10 at every N of its domain (1 to 512) at head dims 64 and 128, and
    on the adversarial head pair (head 1's keys 20x head 0's, a common key
    offset): within two bf16 ulps of the largest output and 99% of outputs
    within one ulp of their own value."""
    name, qkv, H = list(kd.core_q8_cases())[case]
    before = qt.attn_core_pairs_q8.launches
    got = qt.attn_core_pairs_q8(qkv, heads=H)
    torch.cuda.synchronize()
    assert qt.attn_core_pairs_q8.launches == before + 1
    want = qt.attn_core_pairs_q8_plain(qkv, heads=H)
    bf16_close(got, want, name)
    contract_close(got, want, name)


@pytest.mark.parametrize("F", kd.AR_F)
@pytest.mark.parametrize("C", kd.AR_C)
@pytest.mark.parametrize("M", kd.AR_M)
def test_adapter_router_kernel(M, C, F):
    """The dense adapter/router kernel alone (the tail of K3 and K6), bf16
    and fp32 out, with and without the router."""
    from dynamic_tuning_tpu_torch.ops import _build

    lib = _build.library()
    xm, ad, sel = kd.adapter_inputs(M, C, F)
    for dtype in (BF, torch.float32):
        x_mid = xm.to(dtype)
        for with_select in (True, False):
            ms.check_adapter_router(lib, x_mid, *ad, *sel, with_select)
            got = ms.launch_adapter_router(lib, x_mid, xm, *ad, *sel,
                                           with_select)
            torch.cuda.synchronize()
            want = ms.adapter_router_plain(xm, dtype, *ad, *sel,
                                           with_select=with_select)
            assert got[1].shape == (1, M, C) and got[1].dtype == dtype
            bf16_close(got[1], want[1], f"adapt M={M} C={C} F={F}")
            if with_select:
                logits_close(got[2], want[2])


def test_q8_patch_embed_kernel():
    g = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn((128, 224, 224, 3), generator=g, device="cuda").to(BF)
    w = torch.randn((768, 3, 16, 16), generator=g, device="cuda") * 0.06
    b = torch.randn((768,), generator=g, device="cuda") * 0.02
    wq = qt.quantize_conv_weight(w)
    before = qt.q8_patch_embed.launches
    got = qt.q8_patch_embed(x, *wq, b, patch=16)
    torch.cuda.synchronize()
    assert qt.q8_patch_embed.launches == before + 1
    want = qt.q8_patch_embed_plain(x, *wq, b, patch=16, dtype=BF)
    assert got.shape == (128, 196, 768) and got.dtype == BF
    bf16_close(got, want, "stem")


@pytest.mark.parametrize("quant", ["int8", "int8_attn"])
def test_int8_block_launches_only_int8_kernels(quant):
    """A CUDA int8 model runs the int8 kernels and never a bf16 kernel."""
    from dynamic_tuning_tpu_torch.config import ModelConfig, TuningConfig
    from dynamic_tuning_tpu_torch.models.vit import VisionTransformer

    mc = ModelConfig(img_size=64, patch_size=16, embed_dim=128, depth=2,
                     num_heads=2, num_classes=10, quant=quant)
    model = VisionTransformer(mc, tuning=TuningConfig(ffn_num=16),
                              device="cuda")
    x = torch.randn((3, 64, 64, 3), device="cuda")
    ms.reset_launch_counts()
    qt.reset_launch_counts()
    with torch.inference_mode():
        logits, _ = model(x, dispatch=True)
    torch.cuda.synchronize()
    assert torch.isfinite(logits).all()
    assert (ms.attention_sublayer_serving.launches,
            ms.dyt_prologue_serving.launches) == (0, 0)
    assert qt.dyt_prologue_serving_q8.launches == 2
    assert qt.q8_ln_mlp.launches == 2
    assert qt.attn_core_pairs_q8.launches == (2 if quant == "int8_attn"
                                              else 0)
    assert qt.q8_patch_embed.launches == 1


def test_q8_wrappers_raise_on_unsupported_input():
    x, sub, _ = make_inputs(2, 19, 128, 16)
    bad = list(q8_sub(sub))
    bad[2] = sub[2]                                 # bf16 weights, not int8
    with pytest.raises(TypeError):
        qt.attention_sublayer_serving_q8(x, *bad, heads=2)
    with pytest.raises(ValueError, match="head_dim"):
        qt.attention_sublayer_serving_q8(x, *q8_sub(sub), heads=4,
                                         attn_q8=True)


# --- MoE adapter (K7, K8) ----------------------------------------------------
#
# Tolerance as for K3/K6: the MoE tail rounds at the plain version's points
# (bf16 x_mid for the down product, one rounding of the gated bottleneck);
# the fp32 sums (router dots, expert products) run in another order.

MOE_WIDTHS = [(4, 64), (4, 8), (2, 16)]       # (experts, bottleneck)


def moe_inputs(C, E, b, seed=0):
    """(wrouter, wdown2d, bdown2d, wup2d, bup, adapter_scale) on the card:
    router logits of a few units, so the gates differ per token."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s, sc=1.0: torch.randn(s, generator=g, device="cuda") * sc
    wrouter = r(E, C, sc=2.0 / C ** 0.5)
    stacks = ms.moe_kernel_weights(r(E, C, b, sc=0.03), r(E, b, sc=0.02),
                                   r(E, b, C, sc=0.02), BF)
    return (wrouter, *stacks, r(E, C, sc=0.01),
            torch.full((1,), 0.1, device="cuda"))


@pytest.mark.parametrize("xdtype", [BF, torch.float32])
@pytest.mark.parametrize("with_select", [True, False])
@pytest.mark.parametrize("E,b", MOE_WIDTHS)
@pytest.mark.parametrize("B,N,C,H,F", SHAPES)
def test_dyt_prologue_moe_kernel(B, N, C, H, F, E, b, with_select, xdtype):
    x, sub, ad = make_inputs(B, N, C, F, xdtype=xdtype, seed=7)
    moe = moe_inputs(C, E, b, seed=8)
    before = ms.dyt_prologue_serving_moe.launches
    got = ms.dyt_prologue_serving_moe(x, *sub, *moe, *ad[5:], heads=H,
                                      tau=0.7, with_select=with_select)
    torch.cuda.synchronize()
    assert ms.dyt_prologue_serving_moe.launches == before + 1
    want = ms.dyt_prologue_moe_plain(x, *sub, *moe, *ad[5:], heads=H,
                                     tau=0.7, with_select=with_select)
    assert len(got) == (3 if with_select else 2)
    assert got[1].dtype == xdtype and got[1].shape == x.shape
    bf16_close(got[0], want[0], "x_mid")
    bf16_close(got[1], want[1], "adapt")
    if with_select:
        logits_close(got[2], want[2])


@pytest.mark.parametrize("attn_q8", [False, True], ids=["core", "int8_attn"])
@pytest.mark.parametrize("with_select", [True, False])
@pytest.mark.parametrize("E,b", MOE_WIDTHS)
@pytest.mark.parametrize("B,N,C,H,F", SHAPES)
def test_dyt_prologue_q8_moe_kernel(B, N, C, H, F, E, b, with_select,
                                    attn_q8):
    x, sub, ad = make_inputs(B, N, C, F, seed=9)
    moe = moe_inputs(C, E, b, seed=10)
    before = (qt.dyt_prologue_serving_q8_moe.launches,
              qt.attn_core_pairs_q8.launches)
    got = qt.dyt_prologue_serving_q8_moe(x, *q8_sub(sub), *moe, *ad[5:],
                                         heads=H, tau=0.7,
                                         with_select=with_select,
                                         attn_q8=attn_q8)
    torch.cuda.synchronize()
    assert (qt.dyt_prologue_serving_q8_moe.launches,
            qt.attn_core_pairs_q8.launches) == (before[0] + 1,
                                                before[1] + attn_q8)
    want = qt.dyt_prologue_q8_moe_plain(x, *q8_sub(sub), *moe, *ad[5:],
                                        heads=H, tau=0.7,
                                        with_select=with_select,
                                        attn_q8=attn_q8)
    assert len(got) == (3 if with_select else 2)
    bf16_close(got[0], want[0], "x_mid")
    bf16_close(got[1], want[1], "adapt")
    if with_select:
        logits_close(got[2], want[2])


@pytest.mark.parametrize("quant", ["none", "int8", "int8_attn"])
def test_moe_model_launches_only_moe_prologue(quant):
    """A CUDA MoE model runs the MoE prologue in every block (and the int8
    MLP under int8), never the dense-adapter prologues."""
    from dynamic_tuning_tpu_torch.config import ModelConfig, TuningConfig
    from dynamic_tuning_tpu_torch.models.vit import VisionTransformer

    mc = ModelConfig(img_size=64, patch_size=16, embed_dim=128, depth=2,
                     num_heads=2, num_classes=10, quant=quant)
    model = VisionTransformer(mc, tuning=TuningConfig(ffn_num=16,
                                                      moe_experts=4),
                              device="cuda")
    x = torch.randn((3, 64, 64, 3), device="cuda")
    ms.reset_launch_counts()
    qt.reset_launch_counts()
    with torch.inference_mode():
        logits, _ = model(x, dispatch=True)
    torch.cuda.synchronize()
    assert torch.isfinite(logits).all()
    q8 = quant != "none"
    assert (ms.attention_sublayer_serving.launches,
            ms.dyt_prologue_serving.launches,
            qt.attention_sublayer_serving_q8.launches,
            qt.dyt_prologue_serving_q8.launches) == (0, 0, 0, 0)
    assert ms.dyt_prologue_serving_moe.launches == (0 if q8 else 2)
    assert qt.dyt_prologue_serving_q8_moe.launches == (2 if q8 else 0)
    assert qt.q8_ln_mlp.launches == (2 if q8 else 0)
    assert qt.attn_core_pairs_q8.launches == (2 if quant == "int8_attn"
                                              else 0)
    assert qt.q8_patch_embed.launches == (1 if q8 else 0)


@pytest.mark.parametrize("E,b", [(3, 8), (1, 64), (4, 132)])
def test_moe_wrappers_raise_on_unsupported_width(E, b):
    x, sub, ad = make_inputs(2, 19, 128, 16)
    moe = moe_inputs(128, E, b)
    with pytest.raises(ValueError, match="MoE width"):
        ms.dyt_prologue_serving_moe(x, *sub, *moe, *ad[5:], heads=2, tau=1.0)
    with pytest.raises(ValueError, match="MoE width"):
        qt.dyt_prologue_serving_q8_moe(x, *q8_sub(sub), *moe, *ad[5:],
                                       heads=2, tau=1.0)


# the MoE tail alone at every form it takes: 2, 4 and 8 experts, W = E*b
# from 32 to 512 (128-row tiles up to 256, 64-row tiles in two passes
# past it), ragged rows, C of one chunk and of ViT-B
MOE_TAIL_WIDTHS = [(2, 16), (4, 8), (2, 48), (4, 16), (8, 16), (4, 64),
                   (8, 32), (4, 80), (2, 256), (8, 64), (4, 128)]


@pytest.mark.parametrize("C", [64, 768])
@pytest.mark.parametrize("M", [1, 63, 129])
@pytest.mark.parametrize("E,b", MOE_TAIL_WIDTHS)
def test_moe_tail_kernel(E, b, M, C):
    from dynamic_tuning_tpu_torch.ops import _build

    g = torch.Generator(device="cuda").manual_seed(23)
    xm = torch.randn((1, M, C), generator=g, device="cuda")
    x_mid = xm.to(BF)
    moe = moe_inputs(C, E, b, seed=24)
    sel = (torch.randn((1, C), generator=g, device="cuda") * 25 / C ** 0.5,
           torch.randn((1,), generator=g, device="cuda") * 0.1)
    lib = _build.library()
    for with_select in (True, False):
        ms.check_moe_adapter_router(lib, x_mid, *moe, *sel, with_select)
        got = ms.launch_moe_adapter_router(lib, x_mid, xm, *moe, *sel, 0.7,
                                           with_select)
        torch.cuda.synchronize()
        want = ms.moe_adapter_router_plain(xm, BF, *moe, *sel, experts=E,
                                           bneck=b, tau=0.7,
                                           with_select=with_select)
        assert got[1].shape == (1, M, C) and got[1].dtype == BF
        bf16_close(got[1], want[1], f"adapt E={E} b={b}")
        if with_select:
            logits_close(got[2], want[2])


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


# --- windowed attention (K9) -------------------------------------------------
#
# Tolerance as for the attention core: the kernel rounds at the plain
# version's points (bf16 q', bf16 bias, bf16 e, one rounding of the output);
# only the order of the fp32 score, l and AV sums differs.

def windowed_inputs(B, N, H, hd=64, *, seed=11, bias_dtype=BF):
    """qkv [B, N, 3C] bf16 at serving scales and a bias [H, N, N] of the
    size of the scores (~1), contiguous."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((B, N, 3 * H * hd), generator=g, device="cuda")
    bias = torch.randn((H, N, N), generator=g, device="cuda")
    return qkv.to(BF), bias.to(bias_dtype)


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("bias_dtype", [BF, torch.float32],
                         ids=["bf16_bias", "fp32_bias"])
@pytest.mark.parametrize("B", [1, 2, 3])
@pytest.mark.parametrize("N", [17, 63, 64, 65, 197, 1025, 1040, 1100])
def test_mha_windowed_kernel(N, B, bias_dtype, hd):
    """N on each side of the 64-key and 64-row tiles (one tile; 17 and 18
    tiles, the last one short), B past the pairs of samples the grid runs
    side by side, both head dims; held to two bf16
    ulps and to the contract check (99% of outputs within one ulp of the
    plain version's own value)."""
    H = 12 if hd == 64 else 4
    qkv, bias = windowed_inputs(B, N, H, hd, bias_dtype=bias_dtype)
    before = ms.mha_windowed_fused.launches
    got = ms.mha_windowed_fused(qkv, bias, heads=H)
    torch.cuda.synchronize()
    assert ms.mha_windowed_fused.launches == before + 1
    want = ms.mha_windowed_plain(qkv, bias, heads=H)
    assert got.dtype == BF and got.shape == (B, N, H * hd)
    bf16_close(got, want, "core")
    contract_close(got, want, "core")


@pytest.mark.parametrize("B", [1, 2])
def test_mha_windowed_kernel_ulp_share(B):
    """At the segmentation path's shape (N = 1025, 12 heads of 64, the
    layer's padded bf16 bias), 99% of K9's outputs lie within one bf16 ulp
    of the plain version's own value (ops/flash_attention.ulp_share)."""
    from dynamic_tuning_tpu_torch.ops import flash_attention as fa
    qkv, _ = windowed_inputs(B, 1025, 12, seed=19)
    ld = ms.bias_row_stride(1025)
    bias = (torch.randn((12, 1025, ld), device="cuda").to(BF)
            [:, :, :1025])
    got = ms.mha_windowed_fused(qkv, bias, heads=12)
    share = fa.ulp_share(got, ms.mha_windowed_plain(qkv, bias, heads=12))
    assert share >= fa.ULP_SHARE, share


def test_mha_windowed_kernel_fp32_bias_view():
    """An fp32 bias given as a view with padded rows (row stride past N)
    is rounded to bf16 into the kernel's layout."""
    qkv, _ = windowed_inputs(2, 101, 12, seed=20)
    bias = torch.randn((12, 101, 120), device="cuda")[:, :, :101]
    assert bias.stride(1) == 120 and not bias.is_contiguous()
    got = ms.mha_windowed_fused(qkv, bias, heads=12)
    torch.cuda.synchronize()
    want = ms.mha_windowed_plain(qkv, bias, heads=12)
    bf16_close(got, want, "core")
    contract_close(got, want, "core")


def test_mha_windowed_kernel_padded_bias_and_head_dim_128():
    """The layer's padded bias (a view with row stride N rounded up to 8)
    goes to the kernel as it is; head_dim 128."""
    from dynamic_tuning_tpu_torch.models.layers import \
        _rel_pos_bias_from_table
    qkv, _ = windowed_inputs(2, 50, 2, hd=128, seed=12)
    table = torch.randn((15 * 15 + 3, 2), device="cuda")
    bias = _rel_pos_bias_from_table(table.to(BF), 7, 7,
                                    row_stride=ms.bias_row_stride(50))
    assert bias.stride(1) == 56
    got = ms.mha_windowed_fused(qkv, bias, heads=2)
    torch.cuda.synchronize()
    bf16_close(got, ms.mha_windowed_plain(qkv, bias, heads=2), "core")


def test_mha_windowed_bias_matters():
    qkv, bias = windowed_inputs(1, 197, 12, seed=13)
    a = ms.mha_windowed_fused(qkv, bias, heads=12)
    b = ms.mha_windowed_fused(qkv, torch.zeros_like(bias), heads=12)
    assert (a.float() - b.float()).abs().max() > 0.05


def test_mha_windowed_raises_on_unsupported_input():
    qkv, bias = windowed_inputs(1, 17, 4, hd=32)
    with pytest.raises(ValueError, match="head_dim"):
        ms.mha_windowed_fused(qkv, bias, heads=4)
    qkv, bias = windowed_inputs(1, 17, 2)
    with pytest.raises(TypeError):
        ms.mha_windowed_fused(qkv.float(), bias, heads=2)
    with pytest.raises(ValueError, match="bias"):
        ms.mha_windowed_fused(qkv, bias[:, :16, :16], heads=2)


def test_seg_model_launches_only_k9():
    """A CUDA segmentor runs K9 in every block (the module path), never the
    image model's fused sublayers."""
    from dynamic_tuning_tpu_torch.config import ModelConfig, TuningConfig
    from dynamic_tuning_tpu_torch.models.upernet import DyTSegmentor

    mc = ModelConfig(img_size=64, patch_size=16, embed_dim=128, depth=4,
                     num_heads=2)
    model = DyTSegmentor(mc, num_classes=7, tuning=TuningConfig(ffn_num=16),
                         head_channels=64, device="cuda")
    x = torch.randn((1, 64, 64, 3), device="cuda")
    ms.reset_launch_counts()
    qt.reset_launch_counts()
    with torch.inference_mode():
        logits, _, aux = model(x, dispatch=True, aux_logits=False)
    torch.cuda.synchronize()
    assert logits.shape == (1, 64, 64, 7) and torch.isfinite(logits).all()
    assert ms.mha_windowed_fused.launches == 4
    assert (ms.attention_sublayer_serving.launches,
            ms.dyt_prologue_serving.launches,
            ms.dyt_prologue_serving_moe.launches) == (0, 0, 0)


# --- fused LN + MLP (K11) ----------------------------------------------------
#
# Tolerance as for K2: the kernel rounds at the plain version's points (bf16
# xn, bf16 h, one rounding of the output); only the order of the fp32 LN and
# GEMM sums differs.  A gated-off row is exactly 0.

def k11_inputs(M, C, H, *, xdtype=BF, gated=False, seed=14):
    g = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s, sc=1.0: torch.randn(s, generator=g, device="cuda") * sc
    mlp = (r(C, sc=0.05) + 1.0, r(C, sc=0.02), r(H, C, sc=0.03).to(BF),
           r(H, sc=0.02), r(C, H, sc=0.03).to(BF), r(C, sc=0.02))
    gate = ((torch.rand((M, 1), generator=g, device="cuda") > 0.5).to(xdtype)
            if gated else None)
    return r(M, C).to(xdtype), mlp, gate


@pytest.mark.parametrize("gelu_approx", [True, False], ids=["tanh", "erf"])
@pytest.mark.parametrize("gated", [False, True], ids=["no_gate", "gate"])
@pytest.mark.parametrize("xdtype", [BF, torch.float32])
@pytest.mark.parametrize("M,C,H", [(128 * 99, 768, 3072),
                                   (128 * 197, 768, 3072), (77, 128, 512),
                                   (129, 768, 3072)])
def test_fused_ln_mlp_kernel(M, C, H, xdtype, gated, gelu_approx):
    from dynamic_tuning_tpu_torch.ops import fused_mlp as fm

    x, mlp, gate = k11_inputs(M, C, H, xdtype=xdtype, gated=gated)
    before = fm.fused_ln_mlp.launches
    got = fm.fused_ln_mlp(x, *mlp, gate, gelu_approx=gelu_approx)
    torch.cuda.synchronize()
    assert fm.fused_ln_mlp.launches == before + 1
    want = fm.ln_mlp_plain(x, *mlp, gate, gelu_approx=gelu_approx)
    assert got.dtype == xdtype and got.shape == x.shape
    bf16_close(got, want, "mlp")
    if gated:
        off = gate[:, 0] == 0
        assert off.any() and bool((got[off] == 0).all())


def test_fused_ln_mlp_raises_on_unsupported_input():
    from dynamic_tuning_tpu_torch.ops import fused_mlp as fm

    x, mlp, _ = k11_inputs(19, 128, 512)
    with pytest.raises(TypeError):                  # fp32 weights
        fm.fused_ln_mlp(x, *mlp[:2], mlp[2].float(), *mlp[3:])
    with pytest.raises(ValueError, match="gate"):
        fm.fused_ln_mlp(x, *mlp, torch.ones((18, 1), device="cuda"))
    with pytest.raises(ValueError, match="multiples of 8"):
        x2, mlp2, _ = k11_inputs(19, 132, 512)
        fm.fused_ln_mlp(x2, *mlp2)


def test_fast_forward_launches_only_k11():
    """The speed-test forward on the card runs K11 once per block with
    use_kernel=True, and no kernel without it."""
    from dynamic_tuning_tpu_torch.config import (ModelConfig, SelectConfig,
                                                 TuningConfig)
    from dynamic_tuning_tpu_torch.models import fast_inference as fast
    from dynamic_tuning_tpu_torch.models.vit import VisionTransformer
    from dynamic_tuning_tpu_torch.ops import fused_mlp as fm

    mc = ModelConfig(img_size=64, patch_size=16, embed_dim=128, depth=2,
                     num_heads=2, num_classes=10, gelu_approx=True)
    tuning, sel = TuningConfig(ffn_num=16), SelectConfig()
    model = VisionTransformer(mc, tuning=tuning, select=sel, device="cuda")
    params = fast.serving_params(model)
    x = torch.randn((3, 64, 64, 3), device="cuda")
    for mode in ("dispatch", "mask", "dense"):
        fm.reset_launch_counts()
        ms.reset_launch_counts()
        qt.reset_launch_counts()
        logits, gates = fast.fast_vit_forward(params, x, cfg=mc,
                                              tuning=tuning, select=sel,
                                              mode=mode, use_kernel=True)
        torch.cuda.synchronize()
        # K11 for the MLP, K15 for the attention, once per block
        assert fm.fused_ln_mlp.launches == 2
        assert ms.mha_serving.launches == 2
        assert (ms.dyt_prologue_serving.launches,
                qt.q8_ln_mlp.launches) == (0, 0)
        assert torch.isfinite(logits).all()
        assert (gates is None) == (mode == "dense")
        fast.fast_vit_forward(params, x, cfg=mc, tuning=tuning, select=sel,
                              mode=mode, use_kernel=False)
        assert fm.fused_ln_mlp.launches == 2
        assert ms.mha_serving.launches == 4


@contextlib.contextmanager
def plain_versions():
    """The wrappers of the fast forward and of the Block swapped for their
    plain versions (on CUDA tensors)."""
    from dynamic_tuning_tpu_torch.ops import fused_mlp as fm

    with contextlib.ExitStack() as stack:
        for mod, name, fn in (
                (fm, "fused_ln_mlp", fm.ln_mlp_plain),
                (ms, "mha_serving", ms.mha_serving_plain),
                (ms, "dyt_prologue_serving", ms.dyt_prologue_plain),
                (qt, "dyt_prologue_serving_q8", qt.dyt_prologue_q8_plain),
                (qt, "q8_ln_mlp", qt.q8_ln_mlp_plain)):
            stack.enter_context(mock.patch.object(mod, name, fn))
        yield


@pytest.mark.parametrize("mode", ["dispatch", "dense"])
def test_fast_forward_at_480_matches_plain_versions(mode):
    """The speed-test forward at 480^2 (901 tokens, K15 on the ring):
    logits within 5% of the largest and gates identical (router heads
    scaled so no logit sits near 0) against the same forward on the plain
    versions."""
    from dynamic_tuning_tpu_torch.config import (ModelConfig, SelectConfig,
                                                 TuningConfig)
    from dynamic_tuning_tpu_torch.models import fast_inference as fast
    from dynamic_tuning_tpu_torch.models.vit import VisionTransformer

    mc = ModelConfig(img_size=480, patch_size=16, embed_dim=128, depth=2,
                     num_heads=2, num_classes=10, gelu_approx=True)
    tuning, sel = TuningConfig(ffn_num=16), SelectConfig()
    torch.manual_seed(25)
    model = VisionTransformer(mc, tuning=tuning, select=sel, device="cuda")
    params = fast.serving_params(model)
    for blk in params["blocks"]:
        w, b = blk["router"]
        blk["router"] = (w * 50, b * 50)
    x = torch.randn((4, 480, 480, 3), device="cuda")
    kw = dict(cfg=mc, tuning=tuning, select=sel, mode=mode, use_kernel=True)
    ms.reset_launch_counts()
    logits, gates = fast.fast_vit_forward(params, x, **kw)
    torch.cuda.synchronize()
    assert ms.mha_serving.launches == 2
    with plain_versions():
        ref, ref_gates = fast.fast_vit_forward(params, x, **kw)
    err = (logits - ref).abs().max().item()
    assert err <= 0.05 * ref.abs().max().item()
    if mode == "dense":
        assert gates is None and ref_gates is None
    else:
        assert torch.equal(gates, ref_gates)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_head_dim_128_block_at_442_tokens(quant):
    """A fusable DyT Block with 2 heads of 128 at N = 442 in dispatch: its
    prologue (K3 or K6, the core on the ring) against the Block on the
    plain versions, outputs within two bf16 ulps and gates identical."""
    from dynamic_tuning_tpu_torch.config import SelectConfig, TuningConfig
    from dynamic_tuning_tpu_torch.models import layers

    torch.manual_seed(26)
    blk = layers.Block(256, 2, torch.Generator().manual_seed(26),
                       quant=quant,
                       tuning=TuningConfig(ffn_num=16, d_model=256),
                       select_cfg=SelectConfig(token_target_ratio=0.5),
                       dtype=BF).to("cuda")
    with torch.no_grad():
        blk.mlp_token_select.mlp_head.weight.mul_(50)
    x = torch.randn((3, 442, 256), device="cuda").to(BF)
    ms.reset_launch_counts()
    qt.reset_launch_counts()
    with torch.inference_mode():
        got = blk(x, False, True)
        torch.cuda.synchronize()
        launched = (qt.dyt_prologue_serving_q8 if quant == "int8"
                    else ms.dyt_prologue_serving).launches
        assert launched == 1
        with plain_versions():
            want = blk(x, False, True)
    bf16_close(got[0], want[0], "block out")
    assert torch.equal(got[1], want[1])
    logits_close(got[2], want[2])


# --- the attention cores K1 and K15, the softmax kernel of K13 and K14 -------
#
# Tolerance as for the attention core: kernel and plain version round at
# the same points (K1: bf16 q', bf16 e, one rounding of the output; K15:
# bf16 q' with the bf16 scale, bf16 p, one rounding; K13/K14: bf16 q, k, v
# and p, the input dtype out); only the order of the fp32 score, max, l and
# AV sums differs.  K13/K14 normalise p before rounding it, so an fp32 p on
# a bf16 boundary may round the other way in either; fp32 outputs are held
# to the same two bf16 ulps.

def core_qkv(B, N, H, hd=64, *, seed=15):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((B, N, 3 * H * hd), generator=g, device="cuda").to(BF)


CORE_SHAPES = [(128, 197, 12, 64),       # ViT-B/16 serving
               (3, 19, 2, 64),           # ragged tokens
               (2, 50, 2, 128),          # head_dim 128
               (2, 5, 2, 64),            # fewer keys than a 16-key step
               (2, 256, 2, 64),          # the longest whole-row N
               (2, 209, 2, 128),         # ... past 13 chunks, head_dim 128
               (8, 257, 12, 64),         # the LayerScale backbone at 256^2
               (1, 800, 2, 64),          # the longest N of the mma.sync core
               (1, 416, 2, 128),         # the longest staged N at hd 128
               (1, 864, 2, 64),          # ... and at hd 64
               # past them, the ring of key/value tiles:
               (1, 865, 2, 64),          # one key past the staged core
               (2, 901, 12, 64),         # 480^2 in 16^2 patches
               (1, 1025, 2, 64),         # 512^2
               (1, 2305, 2, 64),         # 768^2
               (1, 417, 2, 128),         # one key past, head_dim 128
               (2, 442, 6, 128),         # 336^2, 6 heads of 128
               (1, 512, 2, 128),         # the longest N the Block fuses
               (1, 1025, 2, 128)]


@pytest.mark.parametrize("N,hd", [(865, 64), (417, 128)])
def test_core_serves_n_past_its_shared_memory(N, hd):
    """One key past the longest N whose keys and values fit the staged
    core's shared memory, the sublayer chains that run the core serve too
    (the core walks the keys through its ring): K2, K5 and K7 against
    their plain versions."""
    C, H = 2 * hd, 2
    x, sub, ad = make_inputs(2, N, C, 16, seed=21)
    got = ms.attention_sublayer_serving(x, *sub, heads=H)
    torch.cuda.synchronize()
    bf16_close(got, ms.attention_sublayer_plain(x, *sub, heads=H), "K2")
    got = qt.attention_sublayer_serving_q8(x, *q8_sub(sub), heads=H)
    torch.cuda.synchronize()
    bf16_close(got, qt.attention_sublayer_q8_plain(x, *q8_sub(sub), heads=H),
               "K5")
    moe = moe_inputs(C, 4, 16, seed=22)
    got = ms.dyt_prologue_serving_moe(x, *sub, *moe, *ad[5:], heads=H,
                                      tau=1.0)
    torch.cuda.synchronize()
    want = ms.dyt_prologue_moe_plain(x, *sub, *moe, *ad[5:], heads=H,
                                     tau=1.0)
    bf16_close(got[0], want[0], "K7 x_mid")
    bf16_close(got[1], want[1], "K7 adapt")
    logits_close(got[2], want[2])


@pytest.mark.parametrize("B,N,H,hd", CORE_SHAPES)
def test_mha_serving_fused_kernel(B, N, H, hd):
    qkv = core_qkv(B, N, H, hd)
    before = ms.mha_serving_fused.launches
    got = ms.mha_serving_fused(qkv, heads=H)
    torch.cuda.synchronize()
    assert ms.mha_serving_fused.launches == before + 1
    assert got.dtype == BF and got.shape == (B, N, H * hd)
    want = ms.attn_core_pairs(qkv, heads=H)
    bf16_close(got, want, "K1")
    contract_close(got, want, "K1")


@pytest.mark.parametrize("layout", ["contiguous", "views"])
@pytest.mark.parametrize("B,N,H,hd", CORE_SHAPES)
def test_mha_serving_kernel(B, N, H, hd, layout):
    """K15 on pre-split tensors and on views of the raw qkv buffer; its
    output is [B, N, H, hd] memory."""
    q, k, v = core_qkv(B, N, H, hd, seed=16).view(B, N, 3, H, hd).permute(
        2, 0, 3, 1, 4)
    if layout == "contiguous":
        q, k, v = (t.contiguous() for t in (q, k, v))
    before = ms.mha_serving.launches
    got = ms.mha_serving(q, k, v)
    torch.cuda.synchronize()
    assert ms.mha_serving.launches == before + 1
    assert got.shape == (B, H, N, hd) and got.transpose(1, 2).is_contiguous()
    want = ms.mha_serving_plain(q, k, v)
    bf16_close(got, want, "K15")
    contract_close(got, want, "K15")


def test_k15_and_k1_round_differently():
    """At head dim 128 the two modes differ: K15's scale is rounded to bf16
    and its l sums the rounded p."""
    qkv = core_qkv(2, 50, 2, 128, seed=17)
    q, k, v = qkv.view(2, 50, 3, 2, 128).permute(2, 0, 3, 1, 4)
    a = ms.mha_serving(q, k, v).transpose(1, 2).reshape(2, 50, 256)
    b = ms.mha_serving_fused(qkv, heads=2)
    assert not torch.equal(a, b)


def contract_close(got, want, what=""):
    """K1, K15, K13 and K14 beside bf16_close: 99% of outputs within one
    bf16 ulp of their own magnitude (``ulp_share``), which a kernel that
    rounds p or q at another point fails (tests/test_torch_port_attn.py)."""
    from dynamic_tuning_tpu_torch.ops import flash_attention as fa

    share = fa.ulp_share(got, want)
    assert share >= fa.ULP_SHARE, f"{what}: {share} within one ulp"
    return share


@pytest.mark.parametrize("xdtype", [BF, torch.float32])
@pytest.mark.parametrize("B,H,N,hd,with_bias", [
    (128, 12, 197, 64, False),            # the speed-test shape
    (1, 12, 1025, 64, True),              # the seg shape, fp32 rel-pos bias
    (2, 3, 37, 128, True),                # odd N: bias rows on 4 bytes
    (2, 2, 5, 64, False),                 # fewer keys than a 16-key chunk
    (2, 2, 256, 64, True),                # the last register-resident N
    (2, 2, 257, 64, True),                # the first walked N (a slab)
    (1, 2, 1280, 64, True),               # the last slab N at hd 64
    (1, 2, 1281, 64, True),               # the first two-pass N at hd 64
    (1, 3, 1025, 128, True),              # the seg shape at hd 128 (slab)
    (1, 2, 1089, 128, True),              # the first two-pass N at hd 128
    (1, 4, 1577, 64, False),              # video pooling
    (1, 2, 2048, 64, True)])
def test_flash_attention_kernel(B, H, N, hd, with_bias, xdtype):
    from dynamic_tuning_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(18)
    q, k, v = (torch.randn((B, H, N, hd), generator=g, device="cuda")
               .to(xdtype) for _ in range(3))
    bias = (torch.randn((H, N, N), generator=g, device="cuda")
            if with_bias else None)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert got.dtype == xdtype and got.shape == q.shape
    want = fa.flash_attention_plain(q, k, v, bias)
    bf16_close(got, want, "K13")
    contract_close(got, want, "K13")


@pytest.mark.parametrize("N", [37, 300])
def test_flash_attention_kernel_on_a_bias_view(N):
    """A bias view whose rows and base are off 16 bytes (the wrapper copies
    a base off 16 bytes) in both the register-resident and walked forms."""
    from dynamic_tuning_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(20)
    q, k, v = (torch.randn((2, 3, N, 64), generator=g, device="cuda")
               .to(BF) for _ in range(3))
    bias = torch.randn((3, N, N + 3), generator=g, device="cuda")[..., 1:N + 1]
    assert bias.data_ptr() % 16
    got = fa.flash_attention(q, k, v, bias)
    want = fa.flash_attention_plain(q, k, v, bias)
    bf16_close(got, want, "K13")
    contract_close(got, want, "K13")


@pytest.mark.parametrize("xdtype", [BF, torch.float32])
@pytest.mark.parametrize("B,N,C,H", [(128, 197, 768, 12), (2, 64, 512, 4),
                                     (2, 256, 768, 12), (3, 7, 512, 4)])
def test_packed_attention_kernel(B, N, C, H, xdtype):
    from dynamic_tuning_tpu_torch.ops import packed_attention as pa

    qkv = core_qkv(B, N, H, C // H, seed=19).to(xdtype)
    before = pa.packed_attention.launches
    got = pa.packed_attention(qkv, num_heads=H)
    torch.cuda.synchronize()
    assert pa.packed_attention.launches == before + 1
    assert got.dtype == xdtype and got.shape == (B, N, C)
    want = pa.packed_attention_plain(qkv, H)
    bf16_close(got, want, "K14")
    contract_close(got, want, "K14")


def test_attention_wrappers_raise_on_unsupported_input():
    from dynamic_tuning_tpu_torch.ops import flash_attention as fa
    from dynamic_tuning_tpu_torch.ops import packed_attention as pa

    qkv = core_qkv(1, 17, 2)
    q, k, v = qkv.view(1, 17, 3, 2, 64).permute(2, 0, 3, 1, 4)
    # K1: the group contract, dtype, layout, head dim
    with pytest.raises(ValueError, match="divide"):
        ms.mha_serving_fused(qkv, heads=2, group=4)
    with pytest.raises(TypeError):
        ms.mha_serving_fused(qkv.float(), heads=2)
    with pytest.raises(ValueError, match="contiguous"):
        ms.mha_serving_fused(core_qkv(17, 2, 2).transpose(0, 1), heads=2)
    with pytest.raises(ValueError, match="head_dim"):
        ms.mha_serving_fused(core_qkv(1, 17, 2, hd=192), heads=2, group=2)
    # K15: dtype, shapes, alignment
    with pytest.raises(TypeError):
        ms.mha_serving(q.float(), k, v)
    with pytest.raises(ValueError, match="shape"):
        ms.mha_serving(q, k[:, :, :16], v)
    with pytest.raises(ValueError, match="16 bytes"):
        wide = core_qkv(1, 17, 1, hd=72).view(1, 17, 3, 1, 72)
        ms.mha_serving(*(t[..., 1:65] for t in
                         wide.permute(2, 0, 3, 1, 4)))
    # ... and serves an N past the staged core's shared memory (the ring)
    big = core_qkv(1, 2048, 1).view(1, 2048, 3, 1, 64).permute(2, 0, 3, 1, 4)
    bf16_close(ms.mha_serving(*big), ms.mha_serving_plain(*big), "K15")
    # K13: the bias, mixed dtypes, head dim
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    with pytest.raises(TypeError):
        fa.flash_attention(qc, kc, vc, torch.zeros((2, 17, 17), device="cuda",
                                                   dtype=BF))
    with pytest.raises(ValueError, match="bias"):
        fa.flash_attention(qc, kc, vc, torch.zeros((2, 16, 16),
                                                   device="cuda"))
    with pytest.raises(TypeError):
        fa.flash_attention(qc.float(), kc, vc)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(*(t[..., :32].contiguous() for t in (qc, kc, vc)))
    # K14: its contract and layout
    with pytest.raises(ValueError, match="divisible by 4"):
        pa.packed_attention(core_qkv(1, 17, 6), num_heads=6)
    with pytest.raises(ValueError, match="N <= 256"):
        pa.packed_attention(core_qkv(1, 257, 4), num_heads=4)
    with pytest.raises(ValueError, match="contiguous"):
        pa.packed_attention(core_qkv(17, 2, 4).transpose(0, 1), num_heads=4)


def test_layerscale_seg_model_launches_only_k1():
    """A CUDA backbone without windows, with LayerScale and q/v biases, runs
    K1 in every block and no fused sublayer; the BEiT backbone runs K9."""
    from dynamic_tuning_tpu_torch.config import ModelConfig, TuningConfig
    from dynamic_tuning_tpu_torch.models.seg_vit import (SegVisionTransformer,
                                                         beit_backbone)

    mc = ModelConfig(img_size=64, patch_size=16, embed_dim=128, depth=4,
                     num_heads=2)
    x = torch.randn((2, 64, 64, 3), device="cuda")
    for build, kernel in (
            (lambda: SegVisionTransformer(
                mc, TuningConfig(ffn_num=16), use_rel_pos_bias=False,
                init_values=0.1, qv_bias_only=True), "mha_serving_fused"),
            (lambda: beit_backbone(mc, TuningConfig(ffn_num=16)),
             "mha_windowed_fused")):
        model = build().to("cuda")
        ms.reset_launch_counts()
        with torch.inference_mode():
            feats, _ = model(x, dispatch=True)
        torch.cuda.synchronize()
        assert all(torch.isfinite(f).all() for f in feats)
        counts = {n: getattr(ms, n).launches for n in (
            "mha_serving_fused", "mha_windowed_fused",
            "attention_sublayer_serving", "dyt_prologue_serving")}
        assert counts == {n: 4 if n == kernel else 0 for n in counts}


# --- K12 (the fused int8 dispatch MLP) and K16 (the matmul probe) ------------
#
# K12 runs K4's chain on the selected rows: against its plain version as K4
# (two bf16 ulps, the gate identical), and against the Block's unfused
# chain (dispatch_mlp around q8_ln_mlp, the same kernels on gathered rows)
# equal value for value.  K16's int8 product is exact; its bf16 product
# sums in fp32 and is held to two bf16 ulps of a float64 product.

def dispatch_scores(B, N, cap, seed=0):
    """Keep probabilities, CLS +inf: uniform in [0, u) with u such that
    about a tenth of the top ``cap`` fall at or under 0.5 (u = 0.917 at
    N = 197, cap = 99)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    above = min(0.9 * cap / (N - 1), 0.9)
    s = torch.rand((B, N), generator=g, device="cuda") * (0.5 / (1 - above))
    s[:, 0] = float("inf")
    return s


@pytest.mark.parametrize("gelu_approx", [True, False], ids=["tanh", "erf"])
@pytest.mark.parametrize("xdtype", [BF, torch.float32])
@pytest.mark.parametrize("B,N,C,cap", [(128, 197, 768, 99), (3, 19, 128, 7),
                                       (2, 33, 256, 33)])
def test_q8_dispatch_mlp_kernel(B, N, C, cap, xdtype, gelu_approx):
    from dynamic_tuning_tpu_torch.ops import dispatch as D
    x = torch.randn((B, N, C), device="cuda").to(xdtype)
    w = mlp_q8_inputs(C)
    s = dispatch_scores(B, N, cap)
    before = qt.q8_dispatch_mlp.launches
    out, gate = qt.q8_dispatch_mlp(x, s, *w, capacity=cap,
                                   gelu_approx=gelu_approx)
    torch.cuda.synchronize()
    assert qt.q8_dispatch_mlp.launches == before + 1
    assert out.dtype == xdtype and out.shape == x.shape
    assert gate.dtype == xdtype and gate.shape == (B, N)
    want, want_gate = qt.q8_dispatch_mlp_plain(x, s, *w, capacity=cap,
                                               gelu_approx=gelu_approx)
    assert torch.equal(gate, want_gate)
    assert (gate.sum(dim=1) < cap).any()           # the mask runs
    bf16_close(out, want, "out")
    chain, chain_gate = D.dispatch_mlp(
        x, s, cap, lambda r: qt.q8_ln_mlp(r, *w, gelu_approx=gelu_approx))
    assert torch.equal(gate, chain_gate)
    assert torch.equal(out, chain)


def test_q8_dispatch_mlp_raises_on_unsupported_input():
    x = torch.randn((2, 19, 128), device="cuda").to(BF)
    w = mlp_q8_inputs(128)
    s = dispatch_scores(2, 19, 7)
    with pytest.raises(ValueError, match="capacity"):
        qt.q8_dispatch_mlp(x, s, *w, capacity=20)
    with pytest.raises(ValueError, match="scores"):
        qt.q8_dispatch_mlp(x, s[:, :18].contiguous(), *w, capacity=7)
    with pytest.raises(ValueError, match="contiguous"):
        qt.q8_dispatch_mlp(x.transpose(0, 1), s, *w, capacity=7)


# --- the int8 GEMM: every epilogue form --------------------------------------
#
# quant.cu's dyt_gemm_s8 runs one EpiQ8 form on gemm.cuh's int8 kernel at
# any shape.  The int32 sums are exact in any order and each form rounds at
# the points of the torch expression in q8_epilogue_plain (the same fp32 ops
# in the same order), so the raw, out, residual, stem and scatter forms are
# bit-exact; the GELU forms (the kernel's expf / tanhf against torch's) are
# held to two bf16 ulps, and the rows' amax the kernel takes in its
# epilogue to the largest |value| of its own output row, exactly.  Shapes:
# ragged M on each side of the 128-row tile and of the persistent grid, K
# short of one 128-deep k tile and past it, N under one 128-wide tile and on
# both tile widths.

GEMM_S8_MS = [1, 127, 129, 12673]
GEMM_S8_KS = [16, 64, 768, 3072]
GEMM_S8_NS = [8, 40, 768, 2304]
Q8_FORMS = {"out": 0, "gelu_erf": 1, "gelu_tanh": 2, "resid": 3, "stem": 4,
            "scatter": 5, "raw": 6}


def gemm_s8_inputs(M, K, N):
    """int8 a [M, K], w [N, K], fp32 row / column scales and a bias, and
    the exact int32 sums (a float64 product: exact while 127**2 K < 2**53)."""
    g = torch.Generator(device="cuda").manual_seed(7 * M + 3 * K + N)
    i8 = dict(dtype=torch.int8, device="cuda", generator=g)
    a = torch.randint(-127, 128, (M, K), **i8)
    w = torch.randint(-127, 128, (N, K), **i8)
    rs = torch.rand(M, generator=g, device="cuda") * 0.02 + 1e-3
    cs = torch.rand(N, generator=g, device="cuda") * 0.02 + 1e-3
    bias = torch.randn(N, generator=g, device="cuda") * 0.1
    acc = torch.matmul(a.double(), w.double().t()).to(torch.int32)
    return a, w, rs, cs, bias, acc


def q8_epilogue_plain(form, acc, rs, cs, bias, resid=None):
    """quant.cu's q8_epilogue in torch, fp32: the same ops in its order."""
    a = acc.float()                       # int32 -> fp32, to nearest
    if form == "stem":
        return a * (rs[:, None] * cs) + bias
    v = (a * rs[:, None]) * cs
    if form in ("out", "scatter"):
        return v + bias
    if form == "resid":
        return (resid.float() + v) + bias
    return qt.gelu_f32(v + bias, form == "gelu_tanh")


def run_gemm_s8(form, a, w, rs, cs, bias, out, resid=None, out_f32=None,
                row_amax=None, row_map=None):
    from dynamic_tuning_tpu_torch.ops import _build
    lib = _build.library()
    ptr = lambda t: None if t is None else t.data_ptr()
    out_type = {BF: 0, torch.float32: 1, torch.int32: 2}[out.dtype]
    (M, K), N = a.shape, w.shape[0]
    err = lib.dyt_gemm_s8(Q8_FORMS[form], out_type, ptr(a), ptr(w), ptr(rs),
                          ptr(cs), ptr(bias), M, N, K, ptr(out), ptr(resid),
                          ptr(out_f32), ptr(row_amax), ptr(row_map),
                          torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, f"int8 GEMM ({form})")
    torch.cuda.synchronize()


@pytest.mark.parametrize("N", GEMM_S8_NS)
@pytest.mark.parametrize("K", GEMM_S8_KS)
@pytest.mark.parametrize("M", GEMM_S8_MS)
@pytest.mark.parametrize("form,out_dtype", [
    ("raw", torch.int32), ("out", BF), ("out", torch.float32), ("resid", BF),
    ("resid", torch.float32), ("stem", BF), ("scatter", BF),
    ("scatter", torch.float32), ("gelu_erf", torch.float32),
    ("gelu_tanh", torch.float32)])
def test_gemm_s8_epilogue(form, out_dtype, M, K, N):
    a, w, rs, cs, bias, acc = gemm_s8_inputs(M, K, N)
    g = torch.Generator(device="cuda").manual_seed(M + K + N)
    if form == "raw":
        got = torch.empty((M, N), dtype=torch.int32, device="cuda")
        run_gemm_s8(form, a, w, None, None, None, got)
        assert torch.equal(got, acc)
        return
    if form == "scatter":
        # rows to a shuffled place in a taller output, a quarter nowhere
        rows = M + 3
        row_map = torch.randperm(rows, generator=g, device="cuda")[:M]
        row_map[torch.rand(M, generator=g, device="cuda") < 0.25] = -1
        row_map = row_map.to(torch.int32)
        got = torch.zeros((rows, N), dtype=out_dtype, device="cuda")
        run_gemm_s8(form, a, w, rs, cs, bias, got, row_map=row_map)
        want = torch.zeros_like(got)
        kept = row_map >= 0
        want[row_map[kept].long()] = q8_epilogue_plain(
            form, acc, rs, cs, bias)[kept].to(out_dtype)
        assert torch.equal(got, want)
        return
    got = torch.empty((M, N), dtype=out_dtype, device="cuda")
    if form == "resid":
        resid = torch.randn((M, N), generator=g, device="cuda").to(out_dtype)
        xm = torch.empty((M, N), device="cuda")
        run_gemm_s8(form, a, w, rs, cs, bias, got, resid=resid, out_f32=xm)
        want = q8_epilogue_plain(form, acc, rs, cs, bias, resid)
        assert torch.equal(xm, want)
        assert torch.equal(got, want.to(out_dtype))
        return
    if form.startswith("gelu"):
        amax = torch.zeros(M, device="cuda")
        run_gemm_s8(form, a, w, rs, cs, bias, got, row_amax=amax)
        bf16_close(got, q8_epilogue_plain(form, acc, rs, cs, bias), form)
        assert torch.equal(amax, got.abs().amax(dim=1))
        return
    run_gemm_s8(form, a, w, rs, cs, bias, got)
    assert torch.equal(got, q8_epilogue_plain(form, acc, rs, cs, bias)
                       .to(out_dtype))


def test_gemm_s8_refuses_unsupported_shapes():
    """K % 16, N % 8 and the form / output type pairs the entry takes."""
    from dynamic_tuning_tpu_torch.ops import _build
    a, w, rs, cs, bias, _ = gemm_s8_inputs(127, 64, 40)
    out = torch.empty((127, 40), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA error"):
        run_gemm_s8("raw", a, w, None, None, None, out)   # fp32 raw
    with pytest.raises(RuntimeError, match="CUDA error"):
        run_gemm_s8("stem", a, w, rs, cs, bias, out)      # fp32 stem
    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    for M, K, N in ((127, 56, 40), (127, 64, 36)):
        assert lib.dyt_gemm_s8(0, 1, a.data_ptr(), w.data_ptr(),
                               rs.data_ptr(), cs.data_ptr(), bias.data_ptr(),
                               M, N, K, out.data_ptr(), None, None, None,
                               None, stream) != 0


@pytest.mark.parametrize("M,K,N", [(197, 768, 2304), (37, 64, 40),
                                   (512, 512, 512)] + [
    (M, K, N) for M in GEMM_S8_MS for K in GEMM_S8_KS for N in GEMM_S8_NS])
def test_make_mm_int8_kernel_is_exact(M, K, N):
    from dynamic_tuning_tpu_torch.utils import profile_int8 as pi
    a = torch.randint(-127, 128, (M, K), dtype=torch.int8, device="cuda")
    b = torch.randint(-127, 128, (K, N), dtype=torch.int8, device="cuda")
    before = pi.make_mm.launches
    got = pi.make_mm(M, K, N, torch.int8, torch.int32)(a, b)
    torch.cuda.synchronize()
    assert pi.make_mm.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == (M, N)
    assert torch.equal(got, pi.mm_plain(a, b, torch.int32))


@pytest.mark.parametrize("K,N", [(64, 40), (768, 768), (768, 2304),
                                 (768, 3072), (3072, 768)])
@pytest.mark.parametrize("M", [1, 127, 129, 12673])
def test_bf16_gemm_kernel(M, K, N):
    """The hand bf16 GEMM (TMA + wgmma) at ragged M, the serving path's N
    and K and a ragged N, on both tile widths it picks by N (128 wide below
    N = 2048, 256 from there): the raw-store epilogue of K16's probe, held
    as test_make_mm_bf16_kernel holds it."""
    from dynamic_tuning_tpu_torch.utils import profile_int8 as pi
    g = torch.Generator(device="cuda").manual_seed(M + K + N)
    a = torch.randn((M, K), generator=g, device="cuda").to(BF)
    bt = torch.randn((N, K), generator=g, device="cuda").to(BF)
    before = pi.make_mm.launches
    got = pi.make_mm(M, K, N, BF, torch.float32).nt(a, bt)
    torch.cuda.synchronize()
    assert pi.make_mm.launches == before + 1
    want = pi.mm_plain(a, bt.t(), torch.float64)
    err = (got.double() - want).abs().max().item()
    assert err <= 2.0 ** -16 * want.abs().max().item(), err


@pytest.mark.parametrize("M,K,N", [(197, 768, 2304), (37, 64, 40)])
def test_make_mm_bf16_kernel(M, K, N):
    from dynamic_tuning_tpu_torch.utils import profile_int8 as pi
    a = torch.randn((M, K), device="cuda").to(BF)
    b = torch.randn((K, N), device="cuda").to(BF)
    got = pi.make_mm(M, K, N, BF, torch.float32)(a, b)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (M, N)
    # fp32 sums in another order: within 2**-16 of the largest |output| of
    # the float64 product, where sums or outputs rounded to bf16 fail
    want = pi.mm_plain(a, b, torch.float64)
    err = (got.double() - want).abs().max().item()
    assert err <= 2.0 ** -16 * want.abs().max().item(), err


# --- training on the card --------------------------------------------------
#
# The training path is the module path (no hand kernel): on the card it runs
# cuBLAS and torch's own kernels.  fp32 with TF32 off, it agrees with the
# CPU to fp32 summation order.

def _toy_train(device, dtype, *, seed=31, noise=None):
    """(model, images, train): a toy DyT ViT (width 128 in 2 heads of 64,
    so its eval blocks fuse; adapter 16; 17 tokens) on ``device`` from
    seeded weights, and ``train(steps)``, which trains it and returns each
    step's parts."""
    from dynamic_tuning_tpu_torch.config import (ModelConfig, SelectConfig,
                                                 TuningConfig)
    from dynamic_tuning_tpu_torch.models.vit import VisionTransformer
    from dynamic_tuning_tpu_torch.train import engine, optim

    sel = SelectConfig(token_target_ratio=0.5)
    model = VisionTransformer(
        ModelConfig(img_size=32, patch_size=8, embed_dim=128, depth=2,
                    num_heads=2, num_classes=10),
        tuning=TuningConfig(ffn_num=16, d_model=128, dropout=0.0),
        select=sel, dtype=dtype,
        generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for blk in model.blocks:
            blk.mlp_token_select.mlp_head.weight.mul_(50)
            blk.adaptmlp.up_proj.weight.normal_(
                0, 0.05, generator=torch.Generator().manual_seed(seed))
    model.to(device)
    opt = optim.make_optimizer(optim.freeze(model), 1e-3, warmup_epochs=0,
                               steps_per_epoch=10)
    state = engine.TrainState(opt, seed=seed)
    step = engine.make_train_step(model, sel)
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((6, 32, 32, 3), generator=g).to(device)
    y = torch.randint(0, 10, (6,), generator=g).to(device)
    kw = {} if noise is None else dict(gate_noise=noise.to(device))
    return model, x, lambda steps: [step(state, x, y, **kw)
                                    for _ in range(steps)]


def test_train_step_on_the_card_matches_the_cpu():
    g = torch.Generator().manual_seed(5)
    u = torch.rand((6, 2, 16, 1), generator=g).clamp(1e-6, 1 - 1e-6)
    noise = torch.log(u) - torch.log1p(-u)
    card = _toy_train("cuda", torch.float32, noise=noise)[2](3)
    cpu = _toy_train("cpu", torch.float32, noise=noise)[2](3)
    for a, b in zip(card, cpu):
        # one gate flipped moves the keep ratio by 1/192; identical gates
        # summed in another order, by an fp32 rounding
        assert abs(a["keep_ratio"].item() - b["keep_ratio"].item()) < 1e-6
        for k in a:
            assert a[k].item() == pytest.approx(b[k].item(), rel=1e-4,
                                                abs=1e-7), k


def test_training_launches_no_kernel_and_serves_after():
    """bf16 training on the card launches no hand kernel; the model, which
    served before it, then serves in dispatch on K3 what a fresh copy of its
    trained weights serves (the serving weight copies refreshed), and within
    5% of the largest logit of the same forward on the plain versions, gates
    identical."""
    from dynamic_tuning_tpu_torch.models.vit import VisionTransformer

    model, x, train = _toy_train("cuda", BF)
    ms.reset_launch_counts()
    qt.reset_launch_counts()
    with torch.inference_mode():
        before, _ = model(x, dispatch=True)
    torch.cuda.synchronize()
    assert ms.dyt_prologue_serving.launches == 2
    ms.reset_launch_counts()
    parts = train(4)
    torch.cuda.synchronize()
    assert all(getattr(m, k).launches == 0 for m in (ms, qt)
               for k in dir(m) if hasattr(getattr(m, k), "launches"))
    assert all(torch.isfinite(v).all() for p in parts for v in p.values())
    fresh = VisionTransformer(model.cfg, tuning=model.tuning,
                              select=model.select_cfg, dtype=BF)
    fresh.load_state_dict(model.state_dict())
    fresh.to("cuda")
    with torch.inference_mode():
        logits, aux = model(x, dispatch=True)
        torch.cuda.synchronize()
        assert ms.dyt_prologue_serving.launches == 2
        again, _ = fresh(x, dispatch=True)
        with plain_versions():
            ref, ref_aux = model(x, dispatch=True)
    assert not torch.equal(logits, before)
    assert torch.equal(logits, again)
    assert torch.equal(aux["token_select"], ref_aux["token_select"])
    assert (logits - ref).abs().max().item() <= 0.05 * ref.abs().max().item()


@pytest.mark.parametrize("canvas,out", [(256, 224), (224, 32)])
def test_train_augmentation_on_the_card_matches_the_cpu(canvas, out):
    """The runner's train augmentation (crop boxes and flips drawn on the
    host, both PIL passes as fp32 products with TF32 off) on the card
    against the CPU, held as tests/test_transforms_pil_parity.py holds the
    JAX package against PIL: a first-pass product summed in another order
    may land on the other side of a .5 (one count), which the second pass
    can carry to two counts in a few pixels; so every pixel within two
    counts, at most max(1, 2e-5 of them) beyond one, 99.9% exact."""
    from dynamic_tuning_tpu_torch.data import transforms as T
    g = torch.Generator().manual_seed(canvas + out)
    imgs = torch.randint(0, 256, (64, canvas, canvas, 3), generator=g,
                         dtype=torch.uint8)
    (top, left, ch, cw), flips = T.sample_train_draws(
        torch.Generator().manual_seed(5), 64, canvas, canvas)
    cpu = T._pil_resized_crop(imgs, top, left, ch, cw, out)
    card = T._pil_resized_crop(imgs.cuda(), top, left, ch, cw, out).cpu()
    d = (card - cpu).abs()
    beyond = int((d > 1).sum())
    print(f"card vs CPU {canvas}->{out}: exact share "
          f"{(d == 0).float().mean().item():.6f}, max {d.max().item()}, "
          f"{beyond} of {d.numel()} beyond one count")
    assert d.max().item() <= 2.0
    assert beyond <= max(1, int(2e-5 * d.numel()))
    assert (d == 0).float().mean().item() > 0.999
    full = [T.augment_batch(torch.Generator().manual_seed(5), x, out_size=out,
                            train=True).cpu() for x in (imgs, imgs.cuda())]
    assert (full[0] - full[1]).abs().max().item() <= 2.0 / 255 / 0.224 + 1e-5
