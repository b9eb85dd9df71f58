"""The port's last two kernels' plain versions against the JAX package, on
the CPU: K12 ``ops/quant.py::q8_dispatch_mlp`` (the fused int8 dispatch MLP)
and K16 ``scripts/profile_int8.py::make_mm`` (the int8 / bf16 matmul probe),
whose port is ``utils/profile_int8.py``.

The JAX side runs its Pallas kernels in interpret mode: K12 through
``q8_dispatch_mlp(..., interpret=True)``; K16's ``_mm_kernel`` through
``pl.pallas_call(..., interpret=True)``, the script loaded by path (its
``make_mm`` has no interpret switch).  Inputs come from numpy with a fixed
seed and go to both sides.  Toy shapes: K12 at B=2, N=33, C=256, K=17 (the
JAX package's own test), MLP hidden 1024.

Tolerances.  K12: both sides quantize at the same points with the same
rounding and form the int32 sums exactly; XLA and torch differ in the last
bit of fp32 library functions (LN's sums, exp, tanh), which may move an
activation on an int8 rounding boundary to the neighbouring code: outputs
within 1e-4 of the largest magnitude (fp32 x) or 2 bf16 ulps (bf16 x), the
gate identical.  K16: int8 exact; bf16 -> fp32 within 1e-5 of the largest
|output| (fp32 sums in another order than the float64 plain version).
"""

import functools
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from dynamic_tuning_tpu.models import layers as jlayers
from dynamic_tuning_tpu.ops import quant as jq
from dynamic_tuning_tpu_torch.checkpoint import from_flax_params
from dynamic_tuning_tpu_torch.models import layers as tlayers
from dynamic_tuning_tpu_torch.ops import dispatch as D
from dynamic_tuning_tpu_torch.ops import quant as tq
from dynamic_tuning_tpu_torch.utils import profile_int8 as pi
from dynamic_tuning_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, N, C, K, HID = 2, 33, 256, 17, 1024
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, dtype):
    rel = 1e-4 if dtype == "float32" else 2 * 2.0 ** -8
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=rel * np.abs(want).max())


def _scores(case, rs):
    """[B, N] keep probabilities, CLS +inf.  "uniform": a few of the top K
    at or under 0.5; "masked": most of them; "ties": four levels, so the
    capacity boundary cuts through tied scores."""
    s = rs.uniform(size=(B, N)).astype(np.float32)
    if case == "masked":
        s *= 0.6
    elif case == "ties":
        s = (rs.randint(0, 4, size=(B, N)) / 4 + 0.125).astype(np.float32)
    s[:, 0] = np.inf
    return s


def _weights(seed=0):
    rs = np.random.RandomState(seed)

    def f(*s, sc=1.0):
        return (rs.randn(*s) * sc).astype(np.float32)

    return rs, dict(x=f(B, N, C), g=1 + f(C, sc=0.1), b=f(C, sc=0.1),
                    w1=f(C, HID, sc=0.05), b1=f(HID, sc=0.05),
                    w2=f(HID, C, sc=0.05), b2=f(C, sc=0.05))


def _port_args(w):
    """The port's K12 weight arguments: [out, in] int8 with fp32 scales."""
    return (_t(w["g"]), _t(w["b"]), *tq.quantize_weight(_t(w["w1"].T)),
            _t(w["b1"]), *tq.quantize_weight(_t(w["w2"].T)), _t(w["b2"]))


# --- K12 ---------------------------------------------------------------------

@pytest.mark.parametrize("gelu_approx", [False, True])
@pytest.mark.parametrize("case", ["uniform", "masked", "ties"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_q8_dispatch_mlp_plain_matches_jax_kernel(dtype, case, gelu_approx):
    jdt, tdt = DTYPES[dtype]
    rs, w = _weights()
    s = _scores(case, rs)
    j_out, j_gate = jq.q8_dispatch_mlp(
        jnp.asarray(w["x"]).astype(jdt), jnp.asarray(s), w["g"], w["b"],
        w["w1"], w["b1"], w["w2"], w["b2"], capacity=K,
        gelu_approx=gelu_approx, interpret=True)
    out, gate = tq.q8_dispatch_mlp(_t(w["x"]).to(tdt), _t(s), *_port_args(w),
                                   capacity=K, gelu_approx=gelu_approx)
    assert out.dtype == tdt and out.shape == (B, N, C)
    assert gate.dtype == tdt and gate.shape == (B, N)
    np.testing.assert_array_equal(gate.float().numpy(), _np(j_gate))
    _close(out, _np(j_out), dtype)
    kept = gate.sum(dim=1)
    if case == "masked":
        assert (kept < K // 2).all()           # the mask really cuts
    else:
        assert (kept > K // 2).all()
    # tokens not kept get exactly zero
    assert not out[gate == 0].any()


@pytest.mark.parametrize("case", ["uniform", "masked", "ties"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_q8_dispatch_mlp_plain_is_dispatch_around_k4(dtype, case):
    """Zero rows at the masked slots (the JAX one-hot's) or the tokens'
    own rows (the Block's ``dispatch_mlp``): the scatter drops both, so the
    two compositions agree bit for bit."""
    tdt = DTYPES[dtype][1]
    rs, w = _weights(1)
    s, x = _t(_scores(case, rs)), _t(w["x"]).to(tdt)
    args = _port_args(w)
    out, gate = tq.q8_dispatch_mlp(x, s, *args, capacity=K, gelu_approx=True)
    want, want_gate = D.dispatch_mlp(
        x, s, K, lambda r: tq.q8_ln_mlp_plain(r, *args, gelu_approx=True))
    assert torch.equal(gate, want_gate)
    assert torch.equal(out, want)


def test_q8_dispatch_mlp_takes_a_bridged_blocks_int8_weights():
    """``Mlp.q8_weights()`` of a JAX Block carried across the weight bridge
    feed K12 to the JAX ``q8_dispatch_mlp`` on the Block's float weights: K12
    needs no weight mapping of its own."""
    rs = np.random.RandomState(2)
    jb = jlayers.Block(num_heads=2, dtype=jnp.bfloat16)
    params = jb.init(jax.random.PRNGKey(0),
                     jnp.zeros((1, N, C), jnp.bfloat16))["params"]
    params = jax.tree_util.tree_map(
        lambda a: a + (0.05 * rs.randn(*a.shape)).astype(np.float32), params)
    tb = tlayers.Block(C, 2, torch.Generator(), dtype=torch.bfloat16)
    tb.load_state_dict({k[len("blocks.0."):]: _t(v) for k, v in
                        from_flax_params({"blocks_0": params}).items()},
                       strict=True)
    x = rs.randn(B, N, C).astype(np.float32)
    s = _scores("uniform", rs)
    mlp, n2 = params["mlp"], params["norm2"]
    j_out, j_gate = jq.q8_dispatch_mlp(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(s), n2["scale"],
        n2["bias"], mlp["fc1"]["kernel"], mlp["fc1"]["bias"],
        mlp["fc2"]["kernel"], mlp["fc2"]["bias"], capacity=K, interpret=True)
    out, gate = tq.q8_dispatch_mlp(
        _t(x).to(torch.bfloat16), _t(s), tb.norm2.weight.detach(),
        tb.norm2.bias.detach(), *tb.mlp.q8_weights(), capacity=K)
    np.testing.assert_array_equal(gate.float().numpy(), _np(j_gate))
    _close(out, _np(j_out), "bfloat16")


def test_q8_dispatch_mlp_refuses_other_devices():
    rs, w = _weights()
    with pytest.raises(ValueError, match="CPU tensors"):
        tq.q8_dispatch_mlp(_t(w["x"]).to("meta"), _t(_scores("uniform", rs)),
                           *_port_args(w), capacity=K)


# --- K16 ---------------------------------------------------------------------

def _jax_probe():
    """scripts/profile_int8.py, loaded by path (scripts/ on sys.path for its
    ``bench_util`` import)."""
    scripts = os.path.join(REPO, "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    spec = importlib.util.spec_from_file_location(
        "profile_int8_jax", os.path.join(scripts, "profile_int8.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_mm(a, b, out_dtype):
    """The script's ``_mm_kernel`` in interpret mode (its ``make_mm`` runs
    the same pallas_call without the switch)."""
    mod = _jax_probe()
    M, N = a.shape[0], b.shape[1]
    return pl.pallas_call(
        functools.partial(mod._mm_kernel, out_dtype=out_dtype),
        out_shape=jax.ShapeDtypeStruct((M, N), out_dtype),
        interpret=True)(a, b)


PROBE_SHAPES = [(64, 64, 64), (37, 128, 48), (197, 96, 40)]   # M ragged


@pytest.mark.parametrize("M,K_,N_", PROBE_SHAPES)
def test_make_mm_int8_plain_matches_jax_kernel(M, K_, N_):
    rs = np.random.RandomState(M)
    a = rs.randint(-127, 127, (M, K_)).astype(np.int8)
    b = rs.randint(-127, 127, (K_, N_)).astype(np.int8)
    want = np.asarray(_jax_mm(jnp.asarray(a), jnp.asarray(b), jnp.int32))
    mm = pi.make_mm(M, K_, N_, torch.int8, torch.int32)
    got = mm(_t(a), _t(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(mm.nt(_t(a), _t(b.T)).numpy(), want)


@pytest.mark.parametrize("M,K_,N_", PROBE_SHAPES)
def test_make_mm_bf16_plain_matches_jax_kernel(M, K_, N_):
    rs = np.random.RandomState(M)
    a = rs.randn(M, K_).astype(np.float32)
    b = rs.randn(K_, N_).astype(np.float32)
    ja, jb = (jnp.asarray(v).astype(jnp.bfloat16) for v in (a, b))
    want = np.asarray(_jax_mm(ja, jb, jnp.float32))
    got = pi.make_mm(M, K_, N_, torch.bfloat16, torch.float32)(
        _t(a).to(torch.bfloat16), _t(b).to(torch.bfloat16))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_profile_int8_bench_on_the_cpu(dtype):
    """``bench`` on the CPU runs the plain version and times nothing; the
    bound is the card's, from the shape."""
    res = pi.bench(37, 64, 48, dtype, pi.OUT[dtype], "probe", "cpu")
    # against the float64 product: int8 exact, fp32 within its rounding
    tol = 0 if dtype == torch.int8 else 2.0 ** -24 * res["ref_max"]
    assert res["ref_max"] > 0 and res["max_abs_err"] <= tol
    assert res["ms"] is None and res["library_ms"] is None
    nbytes = (37 * 64 + 64 * 48) * (1 if dtype == torch.int8 else 2) \
        + 37 * 48 * 4
    assert res["bound_by"] == "bytes"
    assert res["bound_ms"] == pytest.approx(nbytes / profiling.HBM * 1e3)


def test_profile_int8_main_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pi.main(pi.get_args_parser().parse_args([]))


def test_make_mm_refuses_bad_shapes_and_types():
    with pytest.raises(ValueError, match="K % 16"):
        pi.make_mm(64, 24, 16, torch.int8, torch.int32)
    with pytest.raises(ValueError, match="N % 8"):
        pi.make_mm(64, 32, 12, torch.bfloat16, torch.float32)
    with pytest.raises(ValueError, match="int8 -> int32"):
        pi.make_mm(64, 32, 16, torch.int8, torch.float32)
    with pytest.raises(ValueError, match="int8 -> int32"):
        pi.make_mm(64, 32, 16, torch.float32, torch.float32)
    mm = pi.make_mm(64, 32, 16, torch.int8, torch.int32)
    a = torch.zeros((64, 32), dtype=torch.int8)
    with pytest.raises(ValueError, match="b has shape"):
        mm(a, torch.zeros((16, 32), dtype=torch.int8))
    with pytest.raises(TypeError, match="a is torch.float32"):
        mm(a.float(), torch.zeros((32, 16), dtype=torch.int8))
    with pytest.raises(ValueError, match="contiguous"):
        mm.nt(a, torch.zeros((32, 16), dtype=torch.int8).t())
    with pytest.raises(ValueError, match="CPU or CUDA"):
        mm.nt(a.to("meta"), torch.zeros((16, 32), dtype=torch.int8,
                                        device="meta"))
