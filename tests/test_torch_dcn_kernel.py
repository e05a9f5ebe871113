"""The design premises of the bfloat16 shift-DCN kernel, on the CPU.

The kernel (csrc/dcn_shift.cu) samples each tap from 4 bilinear corners
instead of the (2R+1)^2 triangle knots of the shift form, reads them from
an x slab padded by P = K/2 + R, and runs on the launch plan of
`ops/dcn_cuda.py:plan`. The corner rule and the plan are checked here
against the plain version and the JAX op; the kernel itself is held
against the plain version on the card (`test_torch_cuda.py`).
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from m3dssd_tpu.ops import dcn as jdcn
from m3dssd_tpu_torch.ops import dcn as tdcn
from m3dssd_tpu_torch.ops import dcn_cuda

# one torch thread per test process: the suite runs several workers at
# once, and torch's default of one thread per core made them
# oversubscribe the machine and slow every worker down
torch.set_num_threads(1)

# float32 on both sides, unit-scale sums of a few hundred terms
TOL = dict(rtol=1e-5, atol=1e-5)

# (B, H, W, Cin, Cout) of the flagship's 8 neck DCN layers at 384x1280 bs=1
# and at 512x1760 bs=8
NECK_SHAPES = ([(1, 12, 40, 1024, 512), (1, 24, 80, 512, 512)]
               + [(1, 24, 80, 512, 256)] * 3 + [(1, 48, 160, 256, 256)] * 3
               + [(8, 16, 55, 1024, 512), (8, 32, 110, 512, 512)]
               + [(8, 32, 110, 512, 256)] * 3 + [(8, 64, 220, 256, 256)] * 3)
ODD_SHAPES = [(2, 5, 11, 40, 72), (1, 13, 41, 200, 72), (2, 6, 11, 8, 16),
              (1, 12, 40, 64, 130), (3, 1, 1, 1, 1)]
H100_SMS = 132


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _premise_case(seed, clamp, B=2, H=6, W=9, C=8, Co=5):
    """Offsets past the clamp, exactly on +-clamp and on integers; a zero
    mask; pixels on every border, whose samples leave the image."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    off = (rng.normal(size=(B, H, W, 9, 2)) * 1.3 * clamp).astype(np.float32)
    off[0, 0, 0] = clamp                        # top-left, both +clamp
    off[0, -1, -1] = -clamp                     # bottom-right, both -clamp
    off[1, 0, -1, :, 0] = clamp
    off[1, 0, -1, :, 1] = -clamp
    off[1, -1, 0] = np.round(off[1, -1, 0])     # integer offsets
    off[0, 2, 3] = 0.0
    m = rng.random((B, H, W, 9)).astype(np.float32)
    m[1, 2] = 0.0                               # a zero mask row
    w = (rng.normal(size=(3, 3, C, Co)) * 0.2).astype(np.float32)
    b = rng.normal(size=(Co,)).astype(np.float32)
    return x, off, m, w, b


def _corner_rule(x, off, m, w, b, clamp):
    """The kernel's sampling: per (pixel, tap) clip the offset, take the
    corners floor(o) and floor(o) + 1 with floor(o) capped at R - 1, and
    read them from x zero-padded by P = K/2 + R."""
    B, H, W, C = x.shape
    K, Co = w.shape[0], w.shape[-1]
    R = math.ceil(clamp)
    P = K // 2 + R
    xp = F.pad(x, (0, 0, P, P, P, P)).reshape(B, -1, C)
    Wp = W + 2 * P
    o = off.clamp(-clamp, clamp)
    f = torch.minimum(torch.floor(o), torch.tensor(float(R - 1)))
    lo = o - f
    fi = f.to(torch.int64)
    ys = torch.arange(H)[None, :, None, None]
    xs = torch.arange(W)[None, None, :, None]
    ky = torch.arange(K).repeat_interleave(K)
    kx = torch.arange(K).repeat(K)
    sy = ys + ky + fi[..., 0] + R           # slab row of the upper corner
    sx = xs + kx + fi[..., 1] + R
    cols = torch.zeros(B, H, W, K * K, C)
    for dy, wy in ((0, 1 - lo[..., 0]), (1, lo[..., 0])):
        for dx, wx in ((0, 1 - lo[..., 1]), (1, lo[..., 1])):
            idx = ((sy + dy) * Wp + sx + dx).reshape(B, -1, 1)
            v = torch.gather(xp, 1, idx.expand(-1, -1, C))
            cols += (wy * m * wx)[..., None] * v.reshape(B, H, W, K * K, C)
    out = cols.reshape(B, H * W, -1) @ w.reshape(-1, Co)
    return out.reshape(B, H, W, Co) + b


@pytest.mark.parametrize("clamp", [1.0, 1.5])
def test_bilinear_on_clipped_offsets_is_the_shift_form(clamp):
    """4-corner bilinear sampling (`dcn_v2`) of offsets clipped to +-clamp
    equals the (2R+1)^2-knot shift form and the JAX op."""
    x, off, m, w, b = _premise_case(21, clamp)
    shift = tdcn.dcn_v2_shift_reference(_t(x), _t(off), _t(m), _t(w), _t(b),
                                        clamp=clamp)
    clipped = _t(np.clip(off, -clamp, clamp))
    bilinear = tdcn.dcn_v2(_t(x), clipped, _t(m), _t(w), _t(b))
    torch.testing.assert_close(bilinear, shift, **TOL)
    jax_shift = np.asarray(jdcn.dcn_v2_shift(x, off, m, w, b, clamp=clamp))
    np.testing.assert_allclose(shift.numpy(), jax_shift, **TOL)


@pytest.mark.parametrize("clamp", [1.0, 1.5, 2.0])
def test_kernel_corner_rule_stays_in_the_slab_and_matches(clamp):
    """The kernel's corner indices never leave the padded slab (an offset
    exactly at +R would put floor(o) + 1 outside it) and its sum equals
    the shift form."""
    x, off, m, w, b = _premise_case(8, clamp)
    got = _corner_rule(_t(x), _t(off), _t(m), _t(w), _t(b), clamp)
    want = tdcn.dcn_v2_shift_reference(_t(x), _t(off), _t(m), _t(w), _t(b),
                                       clamp=clamp)
    torch.testing.assert_close(got, want, **TOL)


def _data_gather_rule(gk, off, m, x_shape, K, clamp):
    """The data kernel's gather, step by step: per 8x16 tile of input
    pixels and per tap k, the gk box of the tile shifted by
    (K/2 - ky - R, K/2 - kx - R) and widened by R (zero outside the
    image); the per-(tap, box pixel) table of clipped offsets and mask,
    filled from the window of the tile plus a halo of K/2 + R; and per
    pixel the knots (dy, dx) read at box pixel (qy + R - dy, qx + R - dx)
    where m tri tri is non-zero, summed in the kernel's order."""
    B, H, W, C = x_shape
    KK, pad = K * K, K // 2
    R = math.ceil(clamp)
    P = pad + R
    TH, TW = dcn_cuda.TILE_H, dcn_cuda.TILE_W
    BH, BW = TH + 2 * R, TW + 2 * R
    gk5 = gk.reshape(B, H, W, KK, C)
    o = off.clamp(-clamp, clamp)
    dx = torch.zeros(B, H, W, C)
    qy = torch.arange(TH * TW) // TW
    qx = torch.arange(TH * TW) % TW
    for b in range(B):
        for y0 in range(0, H, TH):
            for x0 in range(0, W, TW):
                tab = torch.zeros(KK, BH * BW, 3)
                for wy in range(TH + 2 * P):
                    for wx in range(TW + 2 * P):
                        gy, gx = y0 - P + wy, x0 - P + wx
                        for k in range(KK):
                            ry = wy - 2 * pad + k // K
                            rx = wx - 2 * pad + k % K
                            if not (0 <= ry < BH and 0 <= rx < BW):
                                continue
                            if 0 <= gy < H and 0 <= gx < W:
                                tab[k, ry * BW + rx] = torch.stack(
                                    [o[b, gy, gx, k, 0], o[b, gy, gx, k, 1],
                                     m[b, gy, gx, k]])
                acc = torch.zeros(TH * TW, C)
                for k in range(KK):
                    oy0 = y0 + pad - k // K - R
                    ox0 = x0 + pad - k % K - R
                    box = torch.zeros(BH, BW, C)
                    ys, xs = max(oy0, 0), max(ox0, 0)
                    ye, xe = min(oy0 + BH, H), min(ox0 + BW, W)
                    if ys < ye and xs < xe:
                        box[ys - oy0:ye - oy0, xs - ox0:xe - ox0] = \
                            gk5[b, ys:ye, xs:xe, k]
                    box = box.reshape(BH * BW, C)
                    for iy in range(2 * R + 1):
                        for ix in range(2 * R + 1):
                            r = (qy + 2 * R - iy) * BW + qx + 2 * R - ix
                            e = tab[k, r]
                            ty = 1 - (e[:, 0] - (iy - R)).abs()
                            tx = 1 - (e[:, 1] - (ix - R)).abs()
                            w = e[:, 2] * ty.clamp(min=0) * tx.clamp(min=0)
                            acc += w[:, None] * box[r]
                acc = acc.reshape(TH, TW, C)
                h, w_ = min(TH, H - y0), min(TW, W - x0)
                dx[b, y0:y0 + h, x0:x0 + w_] = acc[:h, :w_]
    return dx


@pytest.mark.parametrize("K,clamp", [(3, 1.0), (3, 1.5), (5, 1.0)])
def test_data_kernel_gather_rule_matches_plain(K, clamp):
    """The data kernel's per-tap boxes, offset table and knot addressing
    give the plain version's dx: partial tiles over two images, offsets
    past the clamp, on +-clamp and on integers, a zero mask row."""
    rng = np.random.default_rng(4)
    B, H, W, C = 2, 13, 21, 4
    KK = K * K
    off = (rng.normal(size=(B, H, W, KK, 2)) * 1.3 * clamp).astype(np.float32)
    off[0, 0, 0] = clamp
    off[1, -1, -1] = -clamp
    off[0, 5] = np.round(off[0, 5])
    m = rng.random((B, H, W, KK)).astype(np.float32)
    m[1, 2] = 0.0
    gk = rng.normal(size=(B * H * W, KK * C)).astype(np.float32)
    got = _data_gather_rule(_t(gk), _t(off), _t(m), (B, H, W, C), K, clamp)
    want = tdcn.shift_dx_reference(_t(gk), _t(off), _t(m), (B, H, W, C),
                                   K=K, clamp=clamp)
    torch.testing.assert_close(got, want, **TOL)


def _tile_ranges(n, step, count):
    return [(i * step, min(n, (i + 1) * step)) for i in range(count)]


@pytest.mark.parametrize("shape", sorted(set(NECK_SHAPES + ODD_SHAPES)))
@pytest.mark.parametrize("clamp", [1.0, 1.5])
def test_launch_plan_covers_the_problem_and_fills_the_card(shape, clamp):
    B, H, W, C, Co = shape
    R = math.ceil(clamp)
    p = dcn_cuda.plan(B, H, W, C, Co, R, H100_SMS)
    th, tw = p.tile
    assert p.grid[0] == B * p.tiles[0] * p.tiles[1]
    # every output pixel and channel in exactly one tile
    cover = np.zeros((H, W), np.int64)
    for y0, y1 in _tile_ranges(H, th, p.tiles[0]):
        for x0, x1 in _tile_ranges(W, tw, p.tiles[1]):
            assert y0 < y1 and x0 < x1
            cover[y0:y1, x0:x1] += 1
    assert (cover == 1).all()
    chans = np.zeros(Co, np.int64)
    for n0, n1 in _tile_ranges(Co, dcn_cuda.BLOCK_N, p.grid[1]):
        assert n0 < n1
        chans[n0:n1] += 1
    assert (chans == 1).all()
    # every 64-channel chunk in exactly one split, none empty
    nchunks = -(-C // dcn_cuda.BLOCK_K)
    assert p.grid[2] == p.split
    splits = _tile_ranges(nchunks, p.chunks_per_split, p.split)
    assert all(a < b for a, b in splits)
    assert [c for a, b in splits for c in range(a, b)] == list(range(nchunks))
    blocks = p.grid[0] * p.grid[1]
    if blocks * min(nchunks, dcn_cuda.MAX_SPLIT) >= H100_SMS:
        assert blocks * p.split >= H100_SMS
    if blocks >= H100_SMS:
        assert p.split == 1
    assert p.smem_bytes <= dcn_cuda.SMEM_LIMIT
    # two blocks fit on one SM at the flagship's K = 3
    assert 2 * (p.smem_bytes + 1024) <= 233472


def test_launch_plan_splits_the_smallest_neck_layer():
    """1x12x40, 1024->512: 6 tiles x 4 channel blocks = 24 blocks on 132
    SMs; the 16 chunks are split so that the grid fills the card."""
    p = dcn_cuda.plan(1, 12, 40, 1024, 512, 1, H100_SMS)
    assert p.grid[:2] == (6, 4)
    assert p.split > 1 and 24 * p.split >= H100_SMS
    assert p.split * p.chunks_per_split >= 16


def test_launch_plan_refuses_a_slab_beyond_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        dcn_cuda.plan(1, 64, 64, 64, 64, 2, H100_SMS, K=41)


# (B, H, W, C) of the backward's calls: the neck at 384x1280 bs=8 and at
# 512x1760 bs=8, the odd and ragged cases of chip_smoke.py, and the card
# tests' partial tiles (13x21), C = 20 (4 mod 8) and a 3x2 image
BWD_SHAPES = [(8, 12, 40, 1024), (8, 24, 80, 512), (8, 48, 160, 256),
              (8, 16, 55, 1024), (8, 32, 110, 512), (8, 64, 220, 256),
              (2, 5, 11, 40), (1, 13, 41, 64), (1, 13, 41, 200),
              (2, 13, 21, 72), (1, 9, 17, 40), (2, 5, 11, 20), (1, 3, 2, 24)]


@pytest.mark.parametrize("shape", BWD_SHAPES)
@pytest.mark.parametrize("R", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["cols", "data", "coord"])
def test_backward_plan_covers_the_problem_once(kernel, dtype, R, shape):
    """`bwd_plan`: the blocks' tiles (decoded as the kernels decode
    blockIdx.x) cover every pixel of every image exactly once and none
    reaches into another image; the channel chunks are split over
    blockIdx.y so that each chunk is walked by exactly one split, none
    empty, only where the tiles fill fewer than the card's block slots,
    and then into no more blocks than one wave of slots holds; the shared
    memory fits the kernel's blocks per SM (cols and data two, coord one)
    on an SM."""
    B, H, W, C = shape
    p = dcn_cuda.bwd_plan(kernel, B, H, W, C, R, dtype, H100_SMS)
    th, tw = p.tile
    ty, tx = p.tiles
    assert p.grid == (B * ty * tx, p.split)
    cover = np.zeros((B, H, W), np.int64)
    for block in range(p.grid[0]):
        b, i = divmod(block, ty * tx)
        y0, x0 = (i // tx) * th, (i % tx) * tw
        assert b < B and y0 < H and x0 < W
        cover[b, y0:y0 + th, x0:x0 + tw] += 1
    assert (cover == 1).all()
    assert p.chunk * torch.finfo(dtype).bits // 8 == \
        dcn_cuda.BWD_ROW_BYTES[kernel]
    nchunks = -(-C // p.chunk)
    splits = _tile_ranges(nchunks, p.chunks_per_split, p.split)
    assert all(a < b for a, b in splits)
    assert [c for a, b in splits for c in range(a, b)] == list(range(nchunks))
    assert 1 <= p.split <= dcn_cuda.MAX_SPLIT
    slots = dcn_cuda.BWD_BLOCKS_PER_SM[kernel] * H100_SMS
    if p.grid[0] >= slots:
        assert p.split == 1
    assert p.grid[0] * p.split <= max(slots, p.grid[0])
    assert p.smem_bytes <= dcn_cuda.SMEM_LIMIT
    assert dcn_cuda.BWD_BLOCKS_PER_SM[kernel] * (p.smem_bytes + 1024) \
        <= 233472


def test_backward_plan_splits_the_first_neck_layer():
    """8x12x40 at C = 1024 gives 48 tiles for 132 SMs: coord (one block per
    SM) splits its 32 chunks 2 ways, cols and data (two per SM) their 16
    chunks 4 ways; the 48x160 layer's 480 tiles fill the card unsplit."""
    coord = dcn_cuda.bwd_plan("coord", 8, 12, 40, 1024, 1, torch.bfloat16,
                              H100_SMS)
    cols = dcn_cuda.bwd_plan("cols", 8, 12, 40, 1024, 1, torch.bfloat16,
                             H100_SMS)
    data = dcn_cuda.bwd_plan("data", 8, 12, 40, 1024, 1, torch.bfloat16,
                             H100_SMS)
    assert coord.grid == (48, 2) and coord.chunks_per_split == 16
    assert cols.grid == (48, 4) and cols.chunks_per_split == 4
    assert data.grid == (48, 4) and data.chunks_per_split == 4
    for kernel in ("cols", "data", "coord"):
        assert dcn_cuda.bwd_plan(kernel, 8, 48, 160, 256, 1, torch.bfloat16,
                                 H100_SMS).split == 1


def test_backward_plan_refuses_what_the_kernels_cannot_take():
    with pytest.raises(ValueError, match="shared memory"):
        dcn_cuda.bwd_plan("cols", 1, 64, 64, 64, 2, torch.bfloat16,
                          H100_SMS, K=41)
    with pytest.raises(ValueError, match="K = 3"):
        dcn_cuda.bwd_plan("coord", 1, 8, 16, 64, 1, torch.bfloat16,
                          H100_SMS, K=5)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        dcn_cuda.bwd_plan("cols", 1, 8, 16, 64, 1, torch.float16, H100_SMS)
    # data's table holds K^2 taps' boxes: K = 41 is far beyond the SM
    with pytest.raises(ValueError, match="shared memory"):
        dcn_cuda.bwd_plan("data", 1, 64, 64, 64, 2, torch.bfloat16,
                          H100_SMS, K=41)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        dcn_cuda.bwd_plan("data", 1, 8, 16, 64, 1, torch.float16, H100_SMS)
    # K = 5 still fits (one block per SM)
    assert dcn_cuda.bwd_plan("data", 1, 8, 16, 64, 2, torch.bfloat16,
                             H100_SMS, K=5).smem_bytes <= \
        dcn_cuda.SMEM_LIMIT
