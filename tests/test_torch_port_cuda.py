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


@pytest.mark.parametrize("bias_dtype", [BF, torch.float32],
                         ids=["bf16_bias", "fp32_bias"])
@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("N", [17, 197, 1025])
def test_mha_windowed_kernel(N, B, bias_dtype):
    qkv, bias = windowed_inputs(B, N, 12, bias_dtype=bias_dtype)
    before = ms.mha_windowed_fused.launches
    got = ms.mha_windowed_fused(qkv, bias, heads=12)
    torch.cuda.synchronize()
    assert ms.mha_windowed_fused.launches == before + 1
    want = ms.mha_windowed_plain(qkv, bias, heads=12)
    assert got.dtype == BF and got.shape == (B, N, 12 * 64)
    bf16_close(got, want, "core")


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
                                   (128 * 197, 768, 3072), (77, 128, 512)])
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
               (2, 50, 2, 128)]          # head_dim 128


@pytest.mark.parametrize("B,N,H,hd", CORE_SHAPES)
def test_mha_serving_fused_kernel(B, N, H, hd):
    qkv = core_qkv(B, N, H, hd)
    before = ms.mha_serving_fused.launches
    got = ms.mha_serving_fused(qkv, heads=H)
    torch.cuda.synchronize()
    assert ms.mha_serving_fused.launches == before + 1
    assert got.dtype == BF and got.shape == (B, N, H * hd)
    bf16_close(got, ms.attn_core_pairs(qkv, heads=H), "K1")


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
    bf16_close(got, ms.mha_serving_plain(q, k, v), "K15")


def test_k15_and_k1_round_differently():
    """At head dim 128 the two modes differ: K15's scale is rounded to bf16
    and its l sums the rounded p."""
    qkv = core_qkv(2, 50, 2, 128, seed=17)
    q, k, v = qkv.view(2, 50, 3, 2, 128).permute(2, 0, 3, 1, 4)
    a = ms.mha_serving(q, k, v).transpose(1, 2).reshape(2, 50, 256)
    b = ms.mha_serving_fused(qkv, heads=2)
    assert not torch.equal(a, b)


@pytest.mark.parametrize("xdtype", [BF, torch.float32])
@pytest.mark.parametrize("B,H,N,hd,with_bias", [
    (128, 12, 197, 64, False),            # the speed-test shape
    (1, 12, 1025, 64, True),              # the seg shape, fp32 rel-pos bias
    (2, 3, 37, 128, True),                # odd N: bias rows on 4 bytes
    (2, 2, 5, 64, False)])                # fewer keys than a 16-key chunk
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
    bf16_close(got, fa.flash_attention_plain(q, k, v, bias), "K13")


@pytest.mark.parametrize("xdtype", [BF, torch.float32])
@pytest.mark.parametrize("B,N,C,H", [(128, 197, 768, 12), (2, 64, 512, 4)])
def test_packed_attention_kernel(B, N, C, H, xdtype):
    from dynamic_tuning_tpu_torch.ops import packed_attention as pa

    qkv = core_qkv(B, N, H, C // H, seed=19).to(xdtype)
    before = pa.packed_attention.launches
    got = pa.packed_attention(qkv, num_heads=H)
    torch.cuda.synchronize()
    assert pa.packed_attention.launches == before + 1
    assert got.dtype == xdtype and got.shape == (B, N, C)
    bf16_close(got, pa.packed_attention_plain(qkv, H), "K14")


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
    # K15: dtype, shapes, alignment, shared memory
    with pytest.raises(TypeError):
        ms.mha_serving(q.float(), k, v)
    with pytest.raises(ValueError, match="shape"):
        ms.mha_serving(q, k[:, :, :16], v)
    with pytest.raises(ValueError, match="16 bytes"):
        wide = core_qkv(1, 17, 1, hd=72).view(1, 17, 3, 1, 72)
        ms.mha_serving(*(t[..., 1:65] for t in
                         wide.permute(2, 0, 3, 1, 4)))
    with pytest.raises(ValueError, match="shared memory"):
        big = core_qkv(1, 2048, 1).view(1, 2048, 3, 1, 64)
        ms.mha_serving(*big.permute(2, 0, 3, 1, 4))
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


@pytest.mark.parametrize("M,K,N", [(197, 768, 2304), (37, 64, 40),
                                   (512, 512, 512)])
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
