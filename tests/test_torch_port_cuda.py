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
from dynamic_tuning_tpu_torch.ops import quant as qt

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
