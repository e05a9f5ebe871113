"""Modulated deformable convolution v2 (DCNv2).

Layouts follow the reference package's public ops, so both compare like with
like:
    x       [B, H, W, Cin]      (NHWC)
    offset  [B, Ho, Wo, K*K, 2] per-tap (dy, dx) in pixels
    mask    [B, Ho, Wo, K*K]    modulation in [0, 1]
    weight  [Kh, Kw, Cin, Cout]
    bias    [Cout]

`dcn_v2` is the unbounded-offset op: a 4-corner bilinear gather with
per-corner bounds, then one [B*Ho*Wo, K*K*Cin] x [K*K*Cin, Cout] product.

`dcn_v2_shift` is the bounded-offset op of the neck: offsets are clipped to
+-clamp, so each tap's bilinear sample is a triangle-weighted sum of
(2R+1)^2 statically shifted copies of the input (R = ceil(clamp)). On a CUDA
tensor it launches the hand-written kernel (ops/dcn_cuda.py); on a CPU
tensor it runs `dcn_v2_shift_reference`, the plain PyTorch form. Under
autograd it runs as `DCNShiftFunction`, whose backward is the hand-written
backward kernels on the card and `dcn_v2_shift_backward_reference` on the
CPU: both follow the reference package's transpose and its subgradient
conventions at the triangle and clip kinks.

Sampling coordinates and bilinear/triangle weights are computed in float32
whatever the feature dtype (bf16 cannot even represent integer pixel
coordinates above 256).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _coord_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def _bilinear_weights_and_indices(py, px, H: int, W: int):
    """Corner indices and validity-masked bilinear weights for sample points.

    Each of the 4 corners contributes only if it lies inside the feature
    map; the sample point itself may be fractional or outside.
    """
    y0 = torch.floor(py)
    x0 = torch.floor(px)
    ly = py - y0
    lx = px - x0
    hy = 1.0 - ly
    hx = 1.0 - lx
    y0i = y0.to(torch.int64)
    x0i = x0.to(torch.int64)

    corners = []
    for dy, wy in ((0, hy), (1, ly)):
        yy = y0i + dy
        vy = (yy >= 0) & (yy <= H - 1)
        for dx, wx in ((0, hx), (1, lx)):
            xx = x0i + dx
            vx = (xx >= 0) & (xx <= W - 1)
            w = wy * wx * (vy & vx)
            idx = yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)
            corners.append((idx, w))
    return corners


def bilinear_sample(x, py, px):
    """Bilinearly sample x [B,H,W,C] at points (py, px) [B, *S].

    Returns [B, *S, C]; out-of-bounds corners contribute zero.
    """
    B, H, W, C = x.shape
    sshape = tuple(py.shape[1:])
    n = math.prod(sshape)
    ct = _coord_dtype(py.dtype)
    py = py.reshape(B, n).to(ct)
    px = px.reshape(B, n).to(ct)
    xf = x.reshape(B * H * W, C)
    base = (torch.arange(B, device=x.device) * (H * W))[:, None]

    out = torch.zeros((B, n, C), dtype=x.dtype, device=x.device)
    for idx, w in _bilinear_weights_and_indices(py, px, H, W):
        v = xf.index_select(0, (idx + base).reshape(-1))
        out = out + v.reshape(B, n, C) * w[..., None].to(x.dtype)
    return out.reshape((B,) + sshape + (C,))


def bilinear_sample_rows(x, b_idx, py, px):
    """Bilinearly sample x [B,H,W,C] at M scattered points that each carry
    their own batch index: b_idx [M] int, py/px [M, S] pixel coordinates.
    Returns [M, S, C], with the per-corner bounds of `bilinear_sample`.
    """
    B, H, W, C = x.shape
    M, S = py.shape
    ct = _coord_dtype(py.dtype)
    py = py.to(ct)
    px = px.to(ct)
    xf = x.reshape(B * H * W, C)
    base = (b_idx.to(torch.int64).clamp(0, B - 1) * (H * W))[:, None]

    out = torch.zeros((M, S, C), dtype=x.dtype, device=x.device)
    for idx, w in _bilinear_weights_and_indices(py, px, H, W):
        flat = (idx + base).reshape(-1).clamp(0, B * H * W - 1)
        v = xf.index_select(0, flat)
        out = out + v.reshape(M, S, C) * w[..., None].to(x.dtype)
    return out


def _matmul_acc(a, b):
    """a @ b accumulated in >= float32, returned in that type."""
    acc = torch.promote_types(a.dtype, torch.float32)
    return torch.matmul(a.to(acc), b.to(acc))


def dcn_v2(x, offset, mask, weight, bias=None, *, stride: int = 1,
           padding: int = 1, dilation: int = 1):
    """Modulated deformable conv v2 forward (plain PyTorch)."""
    B, H, W, Cin = x.shape
    Kh, Kw, Cin_w, Cout = weight.shape
    if Cin != Cin_w:
        raise ValueError(f"channels {Cin} vs weight {Cin_w}")
    KK = Kh * Kw
    _, Ho, Wo, KK_o, two = offset.shape
    if KK_o != KK or two != 2:
        raise ValueError(f"offset shape {tuple(offset.shape)} for K*K={KK}")

    ct = _coord_dtype(offset.dtype)
    dev = x.device
    ys = torch.arange(Ho, dtype=ct, device=dev) * stride - padding
    xs = torch.arange(Wo, dtype=ct, device=dev) * stride - padding
    tap_y = (torch.arange(Kh, dtype=ct, device=dev) * dilation).repeat_interleave(Kw)
    tap_x = (torch.arange(Kw, dtype=ct, device=dev) * dilation).repeat(Kh)

    off = offset.to(ct)
    py = ys[None, :, None, None] + tap_y[None, None, None, :] + off[..., 0]
    px = xs[None, None, :, None] + tap_x[None, None, None, :] + off[..., 1]

    sampled = bilinear_sample(x, py, px)               # [B,Ho,Wo,KK,Cin]
    sampled = sampled * mask[..., None].to(x.dtype)
    cols = sampled.reshape(B, Ho * Wo, KK * Cin)
    out = _matmul_acc(cols, weight.reshape(KK * Cin, Cout))
    out = out.reshape(B, Ho, Wo, Cout).to(x.dtype)
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out


def shift_geometry(clamp: float, K: int):
    """(pad, window radius R, knot offsets D) of the shifted-MAC form.

    The triangle basis on knots [-R..R] reproduces linear interpolation
    exactly for |offset| <= clamp <= R, so (2R+1)^2 shifts per tap suffice.
    """
    R = int(math.ceil(clamp))
    return K // 2, R, list(range(-R, R + 1))


def dcn_v2_shift_reference(x, offset, mask, weight, bias=None, *,
                           clamp: float = 1.0):
    """Plain PyTorch shifted-MAC form of the clipped-offset DCNv2 forward.

    Offsets are clipped to [-clamp, clamp] in float32 (float64 for float64
    features) before the triangle
    weights max(0, 1 - |o - d|); the modulation mask is folded into the
    y-weights. As in the reference op, the shifted MACs accumulate in the
    feature dtype and each tap's product accumulates in >= float32.
    """
    B, H, W, C = x.shape
    Kh, Kw, _, Cout = weight.shape
    KK = Kh * Kw
    pad, R, D = shift_geometry(clamp, Kh)
    P = pad + R
    ct = _coord_dtype(x.dtype)
    off = offset.to(ct).clamp(-clamp, clamp)
    xp = F.pad(x, (0, 0, P, P, P, P))
    w2 = weight.reshape(KK, C, Cout)
    acc_t = torch.promote_types(x.dtype, torch.float32)
    out = torch.zeros((B, H * W, Cout), dtype=acc_t, device=x.device)
    for k in range(KK):
        ky, kx = k // Kw, k % Kw
        oy = off[..., k, 0]
        ox = off[..., k, 1]
        mk = mask[..., k].to(ct)
        wy = [torch.clamp(1.0 - torch.abs(oy - d), min=0.0) * mk for d in D]
        wx = [torch.clamp(1.0 - torch.abs(ox - d), min=0.0) for d in D]
        acc = torch.zeros((B, H, W, C), dtype=x.dtype, device=x.device)
        for iy, dy in enumerate(D):
            ys = P - pad + ky + dy
            for ix, dx in enumerate(D):
                xs = P - pad + kx + dx
                w = (wy[iy] * wx[ix]).to(x.dtype)
                acc = acc + w[..., None] * xp[:, ys:ys + H, xs:xs + W, :]
        out = out + _matmul_acc(acc.reshape(B, H * W, C), w2[k])
    out = out.reshape(B, H, W, Cout).to(x.dtype)
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out


# subgradient conventions of the reference package's transpose (its
# autodiff's): d|u|/du = +1 at 0, d max(t, 0)/dt = 0.5 at 0, so the clip
# passes 0.5 at |o| = clamp. Torch's own autograd gives abs'(0) = 0.
def _dabs(u):
    return (u >= 0).to(u.dtype) * 2.0 - 1.0


def _dmax0(t):
    """d max(t, 0)/dt evaluated from t (0.5 exactly at the kink)."""
    return (t > 0).to(t.dtype) + 0.5 * (t == 0).to(t.dtype)


def _dtri(o, d):
    """d/do of the triangle weight max(0, 1 - |o - d|)."""
    u = o - d
    return -_dmax0(1.0 - torch.abs(u)) * _dabs(u)


def _dclip(o, clamp):
    """d clip(o, -clamp, clamp)/do (1 inside, 0 outside, 0.5 at the edge)."""
    a = torch.abs(o)
    return (a < clamp).to(o.dtype) + 0.5 * (a == clamp).to(o.dtype)


def _add_shifted(acc, z, sy: int, sx: int):
    """acc[:, y, x] += z[:, y - sy, x - sx] where that is inside, in place
    (the reverse of a shift by (sy, sx))."""
    H, W = z.shape[1:3]
    if abs(sy) >= H or abs(sx) >= W:
        return
    acc[:, max(sy, 0):H + min(sy, 0), max(sx, 0):W + min(sx, 0)] += \
        z[:, max(-sy, 0):H - max(sy, 0), max(-sx, 0):W - max(sx, 0)]


def _tap_weights(offset, mask, k: int, D, ct, clamp: float):
    """(clipped oy, ox, mask, triangle weights wy, wx per knot) of tap k."""
    off = offset[..., k, :].to(ct).clamp(-clamp, clamp)
    oy, ox = off[..., 0], off[..., 1]
    wy = [torch.clamp(1.0 - torch.abs(oy - d), min=0.0) for d in D]
    wx = [torch.clamp(1.0 - torch.abs(ox - d), min=0.0) for d in D]
    return oy, ox, mask[..., k].to(ct), wy, wx


def shift_columns_reference(x, offset, mask, *, K: int = 3,
                            clamp: float = 1.0):
    """The forward's columns [B*H*W, K*K*C] in x's dtype: per tap the
    mask- and triangle-weighted sum of the shifted slices, accumulated in
    x's dtype (the plain version of the `dcn_shift_bwd_cols` kernel)."""
    B, H, W, C = x.shape
    pad, R, D = shift_geometry(clamp, K)
    P = pad + R
    ct = _coord_dtype(x.dtype)
    xp = F.pad(x, (0, 0, P, P, P, P))
    cols = []
    for k in range(K * K):
        ky, kx = k // K, k % K
        _, _, mk, wy, wx = _tap_weights(offset, mask, k, D, ct, clamp)
        acc = torch.zeros((B, H, W, C), dtype=x.dtype, device=x.device)
        for iy, dy in enumerate(D):
            ys = P - pad + ky + dy
            for ix, dxs in enumerate(D):
                xs = P - pad + kx + dxs
                w = (mk * wy[iy] * wx[ix]).to(x.dtype)
                acc = acc + w[..., None] * xp[:, ys:ys + H, xs:xs + W, :]
        cols.append(acc.reshape(B * H * W, C))
    return torch.cat(cols, dim=1)


def shift_dx_reference(gk, offset, mask, x_shape, *, K: int = 3,
                       clamp: float = 1.0):
    """dx [B,H,W,C] in gk's dtype from the per-tap cotangent gk
    [B*H*W, K*K*C]: the reverse shifts of the triangle-weighted gk,
    accumulated in gk's dtype (the plain version of `dcn_shift_bwd_data`)."""
    B, H, W, C = x_shape
    pad, R, D = shift_geometry(clamp, K)
    ct = _coord_dtype(gk.dtype)
    dx = torch.zeros((B, H, W, C), dtype=gk.dtype, device=gk.device)
    for k in range(K * K):
        ky, kx = k // K, k % K
        _, _, mk, wy, wx = _tap_weights(offset, mask, k, D, ct, clamp)
        gkk = gk[:, k * C:(k + 1) * C].reshape(B, H, W, C)
        for iy, dy in enumerate(D):
            ay = (mk * wy[iy]).to(gk.dtype)[..., None] * gkk
            sy = ky + dy - pad
            for ix, dxs in enumerate(D):
                z = wx[ix].to(gk.dtype)[..., None] * ay
                _add_shifted(dx, z, sy, kx + dxs - pad)
    return dx


def shift_coord_reference(x, gk, offset, mask, *, K: int = 3,
                          clamp: float = 1.0):
    """(doffset [B,H,W,K*K,2] in offset's dtype, dmask [B,H,W,K*K] in
    mask's dtype) from x and the per-tap cotangent gk [B*H*W, K*K*C]: per
    tap the C-dot table t of gk against each shifted slice (accumulated in
    >= float32), combined with the triangle weights and their subgradients,
    times the clip's (the plain version of `dcn_shift_bwd_coord`)."""
    B, H, W, C = x.shape
    pad, R, D = shift_geometry(clamp, K)
    P = pad + R
    ct = _coord_dtype(x.dtype)
    acc_t = torch.promote_types(x.dtype, torch.float32)
    xp = F.pad(x, (0, 0, P, P, P, P))
    doff, dmk_l = [], []
    for k in range(K * K):
        ky, kx = k // K, k % K
        oy, ox, mk, wy, wx = _tap_weights(offset, mask, k, D, ct, clamp)
        gkk = gk[:, k * C:(k + 1) * C].reshape(B, H, W, C).to(acc_t)
        t = [[None] * len(D) for _ in D]
        for iy, dy in enumerate(D):
            ys = P - pad + ky + dy
            for ix, dxs in enumerate(D):
                xs = P - pad + kx + dxs
                sl = xp[:, ys:ys + H, xs:xs + W, :].to(acc_t)
                t[iy][ix] = (gkk * sl).sum(-1).to(ct)
        dmk_l.append(sum(wy[iy] * wx[ix] * t[iy][ix]
                         for iy in range(len(D)) for ix in range(len(D))))
        doy = mk * sum(_dtri(oy, d) * wx[ix] * t[iy][ix]
                       for iy, d in enumerate(D) for ix in range(len(D)))
        dox = mk * sum(wy[iy] * _dtri(ox, d) * t[iy][ix]
                       for iy in range(len(D)) for ix, d in enumerate(D))
        doff.append(torch.stack([doy, dox], dim=-1))
    doffset = torch.stack(doff, dim=3) * _dclip(offset.to(ct), clamp)
    return (doffset.to(offset.dtype),
            torch.stack(dmk_l, dim=-1).to(mask.dtype))


def dcn_v2_shift_backward_reference(x, offset, mask, weight, g, *,
                                    clamp: float = 1.0):
    """(dx, doffset, dmask, dweight) of the bias-free shifted-MAC forward
    for the output cotangent g [B,H,W,Cout], in plain PyTorch.

    The written-out transpose of the reference package's
    `_dcn_shift_core_bwd`: the recomputed columns against g for dW, gk =
    g . W^T per tap, dx as the reverse shifts of the triangle-weighted gk,
    and the C-dot table of gk against each shifted slice for the offset and
    mask gradients. Coordinates and weights in float32 (float64 for float64
    features); the products and the dot tables accumulate in >= float32.
    """
    B, H, W, C = x.shape
    K, _, _, Cout = weight.shape
    acc_t = torch.promote_types(x.dtype, torch.float32)
    g2 = g.reshape(B * H * W, Cout).to(acc_t)
    col = shift_columns_reference(x, offset, mask, K=K, clamp=clamp)
    dweight = torch.matmul(col.to(acc_t).t(), g2).reshape(K, K, C, Cout)
    del col
    gk = torch.matmul(g2, weight.reshape(K * K * C, Cout).to(acc_t).t()) \
        .to(x.dtype)
    dx = shift_dx_reference(gk, offset, mask, x.shape, K=K, clamp=clamp)
    doffset, dmask = shift_coord_reference(x, gk, offset, mask, K=K,
                                           clamp=clamp)
    return dx, doffset, dmask, dweight.to(weight.dtype)


class DCNShiftFunction(torch.autograd.Function):
    """Autograd of the shift DCN: the forward keeps only its inputs (x,
    offset, mask, weight) and the backward recomputes the columns.

    On CUDA tensors the forward launches the forward kernel and the backward
    the backward kernels (ops/dcn_cuda.py), each on detached operands; on
    CPU tensors both run the plain versions. There is no other path: a
    CUDA tensor reaches the kernels or raises.
    """

    @staticmethod
    def forward(ctx, x, offset, mask, weight, bias, clamp):
        ctx.clamp = clamp
        ctx.bias_dtype = None if bias is None else bias.dtype
        ctx.save_for_backward(x, offset, mask, weight)
        if x.is_cuda:
            from .dcn_cuda import dcn_v2_shift_cuda

            return dcn_v2_shift_cuda(
                x.detach().contiguous(), offset.detach().contiguous(),
                mask.detach().contiguous(), weight.detach().contiguous(),
                None if bias is None else bias.detach().contiguous(),
                clamp=clamp)
        return dcn_v2_shift_reference(x, offset, mask, weight, bias,
                                      clamp=clamp)

    @staticmethod
    def backward(ctx, g):
        x, offset, mask, weight = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        if x.is_cuda:
            from .dcn_cuda import dcn_v2_shift_backward_cuda

            dx, doff, dm, dw = dcn_v2_shift_backward_cuda(
                x.detach().contiguous(), offset.detach().contiguous(),
                mask.detach().contiguous(), weight.detach().contiguous(), g,
                clamp=ctx.clamp)
        else:
            dx, doff, dm, dw = dcn_v2_shift_backward_reference(
                x, offset, mask, weight, g, clamp=ctx.clamp)
        db = None
        if ctx.bias_dtype is not None:
            acc = torch.promote_types(g.dtype, torch.float32)
            db = g.to(acc).sum((0, 1, 2)).to(ctx.bias_dtype)
        return (dx, doff.to(offset.dtype), dm.to(mask.dtype),
                dw.to(weight.dtype), db, None)


def dcn_v2_shift(x, offset, mask, weight, bias=None, *, clamp: float = 1.0):
    """Deformable conv v2 with offsets clipped to [-clamp, clamp]
    (stride 1, dilation 1, padding K//2).

    A CUDA tensor launches the hand-written kernel; a CPU tensor runs the
    plain form. On the card the operands are brought to the kernel's types
    here: offsets and mask in float32, weight in x's dtype, bias in
    float32. When any operand requires grad (and grad is enabled) the call
    goes through `DCNShiftFunction`.
    """
    if x.is_cuda:
        offset = offset.to(torch.float32)
        mask = mask.to(torch.float32)
        weight = weight.to(x.dtype)
        bias = None if bias is None else bias.to(torch.float32)
    elif x.device.type != "cpu":
        raise NotImplementedError(f"dcn_v2_shift on {x.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, offset, mask, weight, bias)):
        return DCNShiftFunction.apply(x, offset, mask, weight, bias,
                                      float(clamp))
    if x.is_cuda:
        from .dcn_cuda import dcn_v2_shift_cuda

        return dcn_v2_shift_cuda(x.contiguous(), offset.contiguous(),
                                 mask.contiguous(), weight.contiguous(),
                                 None if bias is None else bias.contiguous(),
                                 clamp=clamp)
    return dcn_v2_shift_reference(x, offset, mask, weight, bias, clamp=clamp)
