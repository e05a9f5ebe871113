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
tensor it runs `dcn_v2_shift_reference`, the plain PyTorch form.

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

    Offsets are clipped to [-clamp, clamp] in float32 before the triangle
    weights max(0, 1 - |o - d|); the modulation mask is folded into the
    y-weights. As in the reference op, the shifted MACs accumulate in the
    feature dtype and each tap's product accumulates in >= float32.
    """
    B, H, W, C = x.shape
    Kh, Kw, _, Cout = weight.shape
    KK = Kh * Kw
    pad, R, D = shift_geometry(clamp, Kh)
    P = pad + R
    off = offset.to(torch.float32).clamp(-clamp, clamp)
    xp = F.pad(x, (0, 0, P, P, P, P))
    w2 = weight.reshape(KK, C, Cout)
    acc_t = torch.promote_types(x.dtype, torch.float32)
    out = torch.zeros((B, H * W, Cout), dtype=acc_t, device=x.device)
    for k in range(KK):
        ky, kx = k // Kw, k % Kw
        oy = off[..., k, 0]
        ox = off[..., k, 1]
        mk = mask[..., k].to(torch.float32)
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


def dcn_v2_shift(x, offset, mask, weight, bias=None, *, clamp: float = 1.0):
    """Deformable conv v2 with offsets clipped to [-clamp, clamp]
    (stride 1, dilation 1, padding K//2).

    A CUDA tensor launches the hand-written kernel; a CPU tensor runs the
    plain form. Operands are brought to the kernel's types here: offsets and
    mask in float32, weight in x's dtype, bias in float32.
    """
    if x.is_cuda:
        from .dcn_cuda import dcn_v2_shift_cuda

        return dcn_v2_shift_cuda(
            x.contiguous(), offset.to(torch.float32).contiguous(),
            mask.to(torch.float32).contiguous(),
            weight.to(x.dtype).contiguous(),
            None if bias is None else bias.to(torch.float32).contiguous(),
            clamp=clamp)
    if x.device.type != "cpu":
        raise NotImplementedError(f"dcn_v2_shift on {x.device}")
    return dcn_v2_shift_reference(x, offset, mask, weight, bias, clamp=clamp)
