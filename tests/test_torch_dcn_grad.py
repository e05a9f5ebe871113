"""The port's shift-DCN backward on the CPU against jax.grad of the JAX
package's `dcn_v2_shift`.

Inputs come from a numpy seed. A share of the offsets sits exactly on a
kink of the triangle weights or of the clip (0.0, the knots +-1, +-clamp),
where the JAX conventions (d|u|/du = +1 at 0, max ties split 0.5) differ
from torch autograd's; the zero-initialised DCN offsets of a fresh model
sit at 0.0. The JAX side runs both its autodiff form and its hand-written
transpose (custom_vjp), which are grad-equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3dssd_tpu.ops.dcn import dcn_v2_shift as j_dcn_v2_shift
from m3dssd_tpu_torch.ops.dcn import (DCNShiftFunction, dcn_v2_shift,
                                      dcn_v2_shift_backward_reference,
                                      dcn_v2_shift_reference,
                                      shift_columns_reference,
                                      shift_coord_reference,
                                      shift_dx_reference)

# float32 on both sides: the same sums in another order
TOL32 = 2e-6
# the port in float64 against JAX in float32 on inputs float32 can hold:
# JAX's float32 rounding
TOL64 = 2e-5


def _case(seed, clamp, B=2, H=5, W=7, C=6, Co=5, tie_share=0.5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    off = rng.uniform(-1.6 * clamp, 1.6 * clamp,
                      size=(B, H, W, 9, 2)).astype(np.float32)
    kinks = np.array([0.0, 1.0, -1.0, clamp, -clamp], np.float32)
    pick = rng.uniform(size=off.shape) < tie_share
    off = np.where(pick, kinks[rng.integers(0, 5, size=off.shape)], off)
    m = rng.uniform(size=(B, H, W, 9)).astype(np.float32)
    w = (rng.normal(size=(3, 3, C, Co)) * 0.3).astype(np.float32)
    b = rng.normal(size=(Co,)).astype(np.float32)
    g = rng.normal(size=(B, H, W, Co)).astype(np.float32)
    return x, off.astype(np.float32), m, w, b, g


def _jax_grads(x, off, m, w, b, g, clamp, custom_vjp):
    f = lambda *a: jnp.sum(j_dcn_v2_shift(*a, clamp=clamp,
                                          custom_vjp=custom_vjp) * g)
    return [np.asarray(v) for v in
            jax.grad(f, argnums=(0, 1, 2, 3, 4))(x, off, m, w, b)]


@functools.lru_cache(maxsize=None)
def _case_and_grads(clamp, tie_share, custom_vjp):
    """One case and its JAX gradients, shared by both port dtypes."""
    case = _case(int(clamp * 10) + int(tie_share * 7), clamp,
                 tie_share=tie_share)
    return case, _jax_grads(*case, clamp, custom_vjp)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("custom_vjp", [False, True])
@pytest.mark.parametrize("clamp,tie_share", [(1.0, 0.0), (1.0, 0.5),
                                             (1.5, 0.5), (1.0, 1.0)])
def test_function_grads_match_jax(dtype, custom_vjp, clamp, tie_share):
    """dx, doffset, dmask, dweight and dbias through the autograd Function
    (the model's path) against jax.grad, at random offsets, at offsets
    half on the kinks and all on them."""
    (x, off, m, w, b, g), want = _case_and_grads(clamp, tie_share,
                                                 custom_vjp)
    ts = [torch.tensor(a, dtype=dtype, requires_grad=True)
          for a in (x, off, m, w, b)]
    out = dcn_v2_shift(*ts, clamp=clamp)
    (out * torch.tensor(g, dtype=dtype)).sum().backward()
    tol = TOL32 if dtype == torch.float32 else TOL64
    for name, t, ref in zip(("dx", "doffset", "dmask", "dweight", "dbias"),
                            ts, want):
        assert t.grad.dtype == dtype
        assert _rel(t.grad.numpy(), ref) < tol, name


def test_zero_offsets_gradient_is_not_a_centred_difference():
    """At offset 0.0 the JAX conventions give doy = m * sum_ix wx *
    (-0.5 t[-1] - t[0] + 0.5 t[+1]); torch's own autograd through the plain
    forward gives another value there, which is why the port has a
    written-out backward."""
    x, off, m, w, b, g = _case(3, 1.0, tie_share=0.0)
    off[:] = 0.0
    want = _jax_grads(x, off, m, w, b, g, 1.0, False)[1]
    args = [torch.tensor(a) for a in (x, off, m, w)]
    got = dcn_v2_shift_backward_reference(*args, torch.tensor(g),
                                          clamp=1.0)[1]
    assert _rel(got.numpy(), want) < TOL32
    ts = [torch.tensor(a, requires_grad=True) for a in (x, off, m, w)]
    (dcn_v2_shift_reference(*ts, clamp=1.0) * torch.tensor(g)).sum() \
        .backward()
    assert _rel(ts[1].grad.numpy(), want) > 1e-2


def test_reference_is_its_three_plain_parts():
    """The plain backward is the composition of the plain versions of the
    three kernels (columns, dx, offset/mask) and the two products."""
    x, off, m, w, b, g = _case(5, 1.5, tie_share=0.5)
    x, off, m, w, g = (torch.tensor(a) for a in (x, off, m, w, g))
    dx, doff, dm, dw = dcn_v2_shift_backward_reference(x, off, m, w, g,
                                                       clamp=1.5)
    B, H, W, C = x.shape
    col = shift_columns_reference(x, off, m, clamp=1.5)
    assert col.shape == (B * H * W, 9 * C)
    g2 = g.reshape(-1, w.shape[-1])
    torch.testing.assert_close(dw, (col.t() @ g2).reshape(w.shape),
                               rtol=1e-6, atol=1e-6)
    gk = g2 @ w.reshape(9 * C, -1).t()
    torch.testing.assert_close(dx, shift_dx_reference(gk, off, m, x.shape,
                                                      clamp=1.5))
    d_off, d_m = shift_coord_reference(x, gk, off, m, clamp=1.5)
    torch.testing.assert_close(doff, d_off)
    torch.testing.assert_close(dm, d_m)
    # the columns times the weight are the forward
    out = (col @ w.reshape(9 * C, -1)).reshape(B, H, W, -1)
    torch.testing.assert_close(out, dcn_v2_shift_reference(x, off, m, w,
                                                           clamp=1.5),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("clamp", [1.0, 1.5])
def test_gradcheck_float64_away_from_kinks(clamp):
    """torch.autograd.gradcheck of the Function in float64, with offsets
    kept 0.05 away from every kink, so finite differences see no corner."""
    rng = np.random.default_rng(11)
    B, H, W, C, Co = 1, 2, 3, 2, 2
    knots = np.array([-2.0, -1.0, 0.0, 1.0, 2.0, clamp, -clamp])
    off = rng.uniform(-1.3 * clamp, 1.3 * clamp, size=(B, H, W, 9, 2))
    near = np.abs(off[..., None] - knots).min(-1) < 0.05
    while near.any():
        off[near] = rng.uniform(-1.3 * clamp, 1.3 * clamp, size=near.sum())
        near = np.abs(off[..., None] - knots).min(-1) < 0.05
    args = (torch.tensor(rng.normal(size=(B, H, W, C)), requires_grad=True),
            torch.tensor(off, requires_grad=True),
            torch.tensor(rng.uniform(size=(B, H, W, 9)), requires_grad=True),
            torch.tensor(rng.normal(size=(3, 3, C, Co)), requires_grad=True),
            torch.tensor(rng.normal(size=(Co,)), requires_grad=True))
    assert torch.autograd.gradcheck(
        lambda *a: DCNShiftFunction.apply(*a, clamp), args, eps=1e-6,
        atol=1e-7, rtol=1e-5)


def test_function_saves_only_its_inputs():
    """The forward keeps x, offset, mask and weight for the backward, not
    the [B*H*W, 9*C] columns."""
    x, off, m, w, b, g = _case(7, 1.0)
    ts = [torch.tensor(a, requires_grad=True) for a in (x, off, m, w, b)]
    out = dcn_v2_shift(*ts, clamp=1.0)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 4
    assert [tuple(s.shape) for s in saved] == [a.shape for a in
                                               (x, off, m, w)]
