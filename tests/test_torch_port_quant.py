"""The port's int8 serving ops against the JAX package's, on the CPU.

The port's K4/K5/K6/K10 wrappers take their plain versions for CPU tensors;
the JAX side runs its Pallas kernels in interpret mode (``interpret=True``).
Inputs are made with numpy from a seed and handed to both.  Toy shapes:
B=2, N=17, C=128, 2 heads of 64, adapter 16, MLP hidden 512.

Tolerances.  Both sides quantize at the same points with the same rounding
(half to even, IEEE 127/amax), and form the int32 sums exactly; what differs
is the last bit of fp32 library functions (LN's sums, exp, tanh) between
XLA and torch.  A value that sits on a rounding boundary of the int8 grid
may so take the neighbouring code:
* int8 codes: identical but for at most 1 in 10**4, and those by one step;
* fp32 outputs: within 1e-4 of the largest magnitude;
* bf16 outputs: within 2 bf16 ulps (2 * 2**-8) of the largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_tuning_tpu.ops import quant as jq
from dynamic_tuning_tpu_torch.ops import quant as tq

B, N, C, H, FFN, HID = 2, 17, 128, 2, 16, 512
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, dtype, fp32_rel=1e-4):
    got = got.float().numpy()
    rel = fp32_rel if dtype == "float32" else 2 * 2.0 ** -8
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def _codes_agree(got, want):
    got, want = np.asarray(got, np.int32), np.asarray(want, np.int32)
    off = got != want
    assert off.mean() <= 1e-4, f"{off.sum()} of {off.size} codes differ"
    assert np.abs(got - want).max() <= 1


def _weights(seed=0, n=N, c=C, ffn=FFN):
    rs = np.random.RandomState(seed)

    def f(*s, sc=1.0):
        return (rs.randn(*s) * sc).astype(np.float32)

    return dict(x=f(B, n, c), g=1 + f(c, sc=0.1), b=f(c, sc=0.1),
                wqkv=f(c, 3 * c, sc=0.05), bqkv=f(3 * c, sc=0.05),
                wproj=f(c, c, sc=0.05), bproj=f(c, sc=0.05),
                w1=f(c, HID, sc=0.05), b1=f(HID, sc=0.05),
                w2=f(HID, c, sc=0.05), b2=f(c, sc=0.05),
                wd=f(c, ffn, sc=0.05), bd=f(ffn, sc=0.05),
                wu=f(ffn, c, sc=0.05), bu=f(c, sc=0.05),
                asc=np.array([0.1], np.float32), wsel=f(c, 1, sc=0.1),
                bsel=f(1, sc=0.1))


def _q(w_in_out):
    """A JAX-layout [in, out] fp32 weight quantized by the port (which takes
    torch's [out, in])."""
    return tq.quantize_weight(_t(w_in_out.T))


# --- quantizers --------------------------------------------------------------

def test_quantize_weight_matches_jax():
    rs = np.random.RandomState(1)
    w = (rs.randn(96, 40) * 0.05).astype(np.float32)
    w[:, 3] = 0.0                                   # a zero channel
    jw, js = jq.quantize_weight(jnp.asarray(w))
    tw, ts = tq.quantize_weight(_t(w.T))
    assert tw.dtype == torch.int8 and ts.dtype == torch.float32
    _codes_agree(tw.numpy().T, np.asarray(jw))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js)[0])
    assert ts[3] == 0 and (tw[3] == 0).all()


def test_row_quant_matches_jax():
    rs = np.random.RandomState(2)
    x = (rs.randn(64, 96) * 3).astype(np.float32)
    x[5] = 0.0                                      # a zero row
    x[7, :4] = [0.5, -1.5, 2.5, 127.0]              # exact half steps
    jc, js = jq._row_quant(jnp.asarray(x))
    tc, ts = tq.row_quant(_t(x))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[5] == 0 and (tc[5] == 0).all()
    # 127/amax = 1 on row 7: round half to even gives 0, -2, 2
    assert tc[7, :4].tolist() == [0, -2, 2, 127]


def test_int_matmul_is_exact_past_2_to_24():
    """Sums at K=3072 reach 127*127*3072 = 4.9e7 > 2**24: the plain
    version rounds the exact int32 sum once, as the kernels' s32 -> fp32."""
    rs = np.random.RandomState(8)
    qa = rs.randint(100, 128, (4, 3072)).astype(np.int8)
    qb = rs.randint(100, 128, (5, 3072)).astype(np.int8)
    exact = qa.astype(np.int64) @ qb.astype(np.int64).T
    assert exact.max() > 2 ** 24
    got = tq.int_matmul(_t(qa), _t(qb))
    np.testing.assert_array_equal(got.numpy(), exact.astype(np.float32))


@pytest.mark.parametrize("approximate", [False, True], ids=["erf", "tanh"])
def test_gelu_matches_jax(approximate):
    """Same formula on both sides; XLA's and torch's exp/tanh differ in the
    last bit, which ``1 + tanh`` near -1 (x << 0) turns into an absolute
    error of up to |x| * 2**-24: atol 1e-6 on |x| <= 6."""
    x = np.linspace(-6, 6, 4001).astype(np.float32)
    want = np.asarray(jq._gelu_f32(jnp.asarray(x), approximate))
    got = tq.gelu_f32(_t(x), approximate).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-6)


# --- K4 ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("approximate", [False, True], ids=["erf", "tanh"])
def test_q8_ln_mlp_matches_jax_kernel(approximate, dtype):
    jdt, tdt = DTYPES[dtype]
    w = _weights()
    want = jq.q8_ln_mlp(jnp.asarray(w["x"]).astype(jdt), w["g"], w["b"],
                        w["w1"], w["b1"], w["w2"], w["b2"],
                        gelu_approx=approximate, interpret=True)
    got = tq.q8_ln_mlp(_t(w["x"]).to(tdt), _t(w["g"]), _t(w["b"]),
                       *_q(w["w1"]), _t(w["b1"]), *_q(w["w2"]), _t(w["b2"]),
                       gelu_approx=approximate)
    assert got.dtype == tdt and got.shape == (B, N, C)
    _close(got, _np(want), dtype)


# --- K5, K6 ------------------------------------------------------------------

def _sub(w):
    wq, sq = _q(w["wqkv"])
    wp, sp = _q(w["wproj"])
    return (_t(w["g"]), _t(w["b"]), wq, sq, _t(w["bqkv"]), wp, sp,
            _t(w["bproj"]))


def _jsub(w):
    return (w["g"], w["b"], w["wqkv"], w["bqkv"], w["wproj"], w["bproj"])


@pytest.mark.parametrize("attn_q8", [False, True], ids=["core", "int8_attn"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_attention_sublayer_q8_matches_jax_kernel(dtype, attn_q8):
    jdt, tdt = DTYPES[dtype]
    w = _weights(seed=3)
    want = jq.attention_sublayer_serving_q8(
        jnp.asarray(w["x"]).astype(jdt), *_jsub(w), heads=H,
        attn_q8=attn_q8, interpret=True)
    got = tq.attention_sublayer_serving_q8(_t(w["x"]).to(tdt), *_sub(w),
                                           heads=H, attn_q8=attn_q8)
    assert got.dtype == tdt and got.shape == (B, N, C)
    _close(got, _np(want), dtype)


# K6 with fp32 adapters (the exact route: the exact core and the float64
# tail on the card) at other widths and ragged lengths: (N, C, heads, F).
# Held to 1e-3 of the largest magnitude: the JAX kernel sums its core in
# fp32, the plain version in float64, and at these sizes a few requantized
# core outputs sit on an int8 code boundary and take the neighbouring code,
# which moves their row of x_mid by one code step through proj.
Q8_FP32_DIMS = [(19, 128, 2, 8), (65, 256, 2, 64), (197, 384, 2, 16),
                (65, 512, 2, 256)]
Q8_PROLOGUE_CASES = (
    [pytest.param(d, s, a, None, id=f"{d}-{'router' if s else 'no_router'}"
                                    f"-{'int8_attn' if a else 'core'}")
     for d in DTYPES for s in (True, False) for a in (False, True)]
    + [pytest.param("float32", s, False, dims,
                    id=f"float32-{'router' if s else 'no_router'}-core"
                       f"-N{dims[0]}-hd{dims[1] // dims[2]}-F{dims[3]}")
       for dims in Q8_FP32_DIMS for s in (True, False)]
    # int8 scores with fp32 adapters at head dim 128 (the exact core's
    # int8-score mode on the card)
    + [pytest.param("float32", True, True, (65, 256, 2, 64),
                    id="float32-router-int8_attn-N65-hd128-F64")])


@pytest.mark.parametrize("dtype,with_select,attn_q8,dims", Q8_PROLOGUE_CASES)
def test_dyt_prologue_q8_matches_jax_kernel(dtype, with_select, attn_q8,
                                            dims):
    jdt, tdt = DTYPES[dtype]
    n, width, heads, ffn = dims or (N, C, H, FFN)
    rel = 1e-3 if dims else 1e-4
    w = _weights(seed=4, n=n, c=width, ffn=ffn)
    c = lambda a: jnp.asarray(a).astype(jdt)
    want = jq.dyt_prologue_serving_q8(
        c(w["x"]), *_jsub(w), c(w["wd"]), w["bd"], c(w["wu"]), w["bu"],
        w["asc"], w["wsel"], w["bsel"], heads=heads,
        with_select=with_select, attn_q8=attn_q8, interpret=True)
    ct = lambda a: _t(a.T).to(tdt)
    got = tq.dyt_prologue_serving_q8(
        _t(w["x"]).to(tdt), *_sub(w), ct(w["wd"]), _t(w["bd"]), ct(w["wu"]),
        _t(w["bu"]), _t(w["asc"]), _t(w["wsel"].T), _t(w["bsel"]),
        heads=heads, with_select=with_select, attn_q8=attn_q8)
    assert len(got) == len(want) == (3 if with_select else 2)
    _close(got[0], _np(want[0]), dtype, rel)
    _close(got[1], _np(want[1]), dtype, rel)
    if with_select:
        assert got[2].dtype == torch.float32 and got[2].shape == (B, n, 1)
        _close(got[2], _np(want[2]), "float32", rel)


# --- K10 ---------------------------------------------------------------------

def _jax_core_q8(qkv, jdt, heads=H):
    """The JAX core on one sample at a time (it writes a [N, C] ref)."""
    n, c = qkv.shape[1], qkv.shape[2] // 3
    hd = c // heads
    outs = []
    for s in qkv:
        out = np.zeros((n, c), jdt)
        jq.attn_core_pairs_q8(jnp.asarray(s).astype(jdt), out, heads=heads,
                              hd=hd, scale=hd ** -0.5)
        outs.append(out.astype(np.float32))
    return np.stack(outs)


def _pair_qkv(seed=5, n=N, c=C, heads=H):
    """qkv whose head pairs have k lanes of very different ranges: the
    second head's keys are 20x the first's, and every k lane carries a
    common offset."""
    hd = c // heads
    rs = np.random.RandomState(seed)
    qkv = rs.randn(B, n, 3 * c).astype(np.float32)
    k = qkv[..., c:2 * c].reshape(B, n, heads // 2, 2, hd)
    k[..., 0, :] *= 0.5
    k[..., 1, :] *= 10.0
    qkv[..., c:2 * c] = k.reshape(B, n, c) + 3.0
    return qkv


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_attn_core_q8_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    qkv = _pair_qkv()
    want = _jax_core_q8(qkv, jdt)
    got = tq.attn_core_pairs_q8(_t(qkv).to(tdt), heads=H)
    assert got.dtype == tdt and got.shape == (B, N, C)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("hd,n", [(128, 17), (128, 65), (128, 257),
                                  (64, 65), (64, 257)])
def test_attn_core_q8_matches_jax_across_shapes(hd, n, dtype):
    """K10's plain version (which the card's kernel is held to) against the
    JAX core at head dim 128 (one head pair of width 256) and past one and
    four 64-row query tiles."""
    jdt, tdt = DTYPES[dtype]
    heads = 256 // hd
    qkv = _pair_qkv(n=n, c=256, heads=heads)
    want = _jax_core_q8(qkv, jdt, heads=heads)
    got = tq.attn_core_pairs_q8(_t(qkv).to(tdt), heads=heads)
    assert got.dtype == tdt and got.shape == (B, n, 256)
    _close(got, want, dtype)


def test_attn_core_q8_k_scale_spans_the_head_pair():
    """One k scale per row of a head PAIR: head 0's output depends on head
    1's key range.  Shrinking head 1's keys to head 0's range refines head
    0's k codes and moves head 0's output -- in the JAX kernel and the port
    alike -- while head 0's own inputs are unchanged."""
    qkv = _pair_qkv()
    narrow = qkv.copy()
    narrow[..., C + 64:2 * C] = (qkv[..., C + 64:2 * C] - 3.0) / 20.0 + 3.0
    for q in (qkv, narrow):
        np.testing.assert_allclose(
            tq.attn_core_pairs_q8(_t(q), heads=H).numpy(),
            _jax_core_q8(q, jnp.float32), rtol=0,
            atol=1e-4 * np.abs(_jax_core_q8(q, jnp.float32)).max())
    wide = tq.attn_core_pairs_q8(_t(qkv), heads=H)[..., :64]
    fine = tq.attn_core_pairs_q8(_t(narrow), heads=H)[..., :64]
    assert (wide - fine).abs().max() > 1e-3 * fine.abs().max()


def test_attn_core_q8_centres_k_per_lane():
    """A per-lane offset common to all keys shifts every score of a row by
    a constant, which the normalisation cancels: centring before the
    quantization makes the core blind to it."""
    qkv = _pair_qkv()
    shifted = qkv.copy()
    shifted[..., C:2 * C] += np.linspace(-40, 40, C, dtype=np.float32)
    a = tq.attn_core_pairs_q8(_t(qkv), heads=H)
    b = tq.attn_core_pairs_q8(_t(shifted), heads=H)
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                               atol=1e-5 * a.abs().max().item())


# --- the int8 stem -----------------------------------------------------------

def test_q8_conv_matches_jax():
    rs = np.random.RandomState(6)
    x = rs.randn(2, 32, 48, 3).astype(np.float32)
    x[1] *= 4.0                                     # per-sample scales
    w = (rs.randn(16, 16, 3, 64) * 0.06).astype(np.float32)     # HWIO
    want = jq.q8_conv(jnp.asarray(x), jnp.asarray(w), strides=(16, 16),
                      padding="VALID")
    got = tq.q8_conv(_t(x), _t(w.transpose(3, 2, 0, 1)), patch=16)
    assert got.shape == (2, 2, 3, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6 * np.abs(np.asarray(want)).max())


def test_q8_patch_embed_is_q8_conv_plus_bias():
    rs = np.random.RandomState(7)
    x = _t(rs.randn(2, 32, 32, 3).astype(np.float32))
    w = _t((rs.randn(64, 3, 16, 16) * 0.06).astype(np.float32))
    b = _t(rs.randn(64).astype(np.float32))
    got = tq.q8_patch_embed(x, *tq.quantize_conv_weight(w), b, patch=16,
                            dtype=torch.float32)
    want = (tq.q8_conv(x, w, patch=16) + b).reshape(2, 4, 64)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_wrappers_refuse_other_devices():
    w = _weights()
    meta = lambda t: t.to("meta")
    with pytest.raises(ValueError, match="CPU tensors"):
        tq.q8_ln_mlp(meta(_t(w["x"])), _t(w["g"]), _t(w["b"]), *_q(w["w1"]),
                     _t(w["b1"]), *_q(w["w2"]), _t(w["b2"]))
    with pytest.raises(ValueError, match="CPU tensors"):
        tq.attention_sublayer_serving_q8(meta(_t(w["x"])), *_sub(w), heads=H)
