"""Launch wrappers of the hand-written shift-DCN kernels.

The forward kernels (csrc/dcn_shift.cu) replace the reference package's
TPU kernel `m3dssd_tpu/ops/dcn_pallas.py:dcn_v2_shift_pallas`; their plain
PyTorch version is `ops/dcn.py:dcn_v2_shift_reference`. The forward wrapper
refuses a tensor that requires grad: autograd reaches the kernels through
`ops/dcn.py:DCNShiftFunction`, which passes detached operands.

The backward kernels (csrc/dcn_shift_bwd.cu) replace the reference
package's transpose `m3dssd_tpu/ops/dcn.py:_dcn_shift_core_bwd`; their
plain version is `ops/dcn.py:dcn_v2_shift_backward_reference`.
`dcn_v2_shift_backward_cuda` runs the two matrix products on cuBLAS and the
column build, the input gradient and the offset/mask gradients as the
three kernels, each with its own wrapper and launch count in
`bwd_launches`. All three run on the launch plan of `bwd_plan` (pixel
tiles over rows staged in shared memory).

The dtype selects the kernel: bfloat16 runs the tensor-core (wgmma) kernel
with the launch plan of `plan`, float32 the CUDA-core kernel. `launches`
counts calls of the op that launched a kernel (one per call, whether the
call launches one kernel or, with a split reduction, two); a run resets it
to 0 and reads it back to show that its path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from .dcn import shift_geometry

launches = 0
# launches of each backward kernel (one per wrapper call)
bwd_launches = {"cols": 0, "data": 0, "coord": 0}
_lib = None
_bwd_lib = None

# geometry of the bfloat16 kernel; must agree with csrc/dcn_shift.cu
TILE_H, TILE_W = 8, 16      # output pixels per block: one 8 x 16 tile
BLOCK_N = 128               # output channels per block
BLOCK_K = 64                # input channels per reduction chunk
TILE_BYTES = TILE_H * TILE_W * BLOCK_K * 2   # one A or weight tile, bf16
W_STAGES = 2                # weight tiles in the ring
SMEM_LIMIT = 232448         # dynamic shared memory one H100 block may use
MAX_SPLIT = 64              # gridDim.z of the split reduction


class Plan(NamedTuple):
    """Launch geometry of the bfloat16 kernel for one problem."""
    tile: Tuple[int, int]        # (TILE_H, TILE_W) output pixels per block
    tiles: Tuple[int, int]       # (tiles over H, tiles over W) per image
    grid: Tuple[int, int, int]   # (B * tiles, channel blocks, split)
    split: int                   # ways the channel chunks are split
    chunks_per_split: int        # 64-channel chunks each split reduces
    smem_bytes: int              # dynamic shared memory per block


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=256)
def plan(B: int, H: int, W: int, C: int, Cout: int, R: int, num_sms: int,
         K: int = 3) -> Plan:
    """Tiles, grid, split and shared memory of the bfloat16 kernel.

    Each block owns an 8 x 16 pixel tile of one image by 128 output
    channels. When those blocks number fewer than the card's SMs, the
    reduction over 64-channel chunks is split S ways so that blocks x S
    reaches the SM count where the chunks allow it (S <= 64).
    """
    P = K // 2 + R
    slab = (TILE_H + 2 * P) * (TILE_W + 2 * P) * BLOCK_K * 2
    smem = 1024 + (2 + W_STAGES) * TILE_BYTES + slab
    if smem > SMEM_LIMIT:
        raise ValueError(f"K={K}, R={R}: the x slab needs {smem} bytes of "
                         f"shared memory, more than {SMEM_LIMIT}")
    tiles = (_cdiv(H, TILE_H), _cdiv(W, TILE_W))
    blocks = B * tiles[0] * tiles[1] * _cdiv(Cout, BLOCK_N)
    nchunks = _cdiv(C, BLOCK_K)
    cps = nchunks
    if blocks < num_sms:
        want = min(nchunks, MAX_SPLIT, _cdiv(num_sms, blocks))
        cps = max(1, nchunks // want)
    split = _cdiv(nchunks, cps)
    return Plan(tile=(TILE_H, TILE_W), tiles=tiles,
                grid=(B * tiles[0] * tiles[1], _cdiv(Cout, BLOCK_N), split),
                split=split, chunks_per_split=cps, smem_bytes=smem)


# geometry of the backward's kernels; must agree with csrc/dcn_shift_bwd.cu.
# A chunk holds this many bytes of each staged row: of x's pixel rows
# (cols, coord) and of gk's (pixel, tap) rows (coord, data).
BWD_ROW_BYTES = {"cols": 128, "data": 128, "coord": 64}
# blocks one SM holds at K = 3
BWD_BLOCKS_PER_SM = {"cols": 2, "data": 2, "coord": 1}
DATA_STAGES = 2             # tap boxes in the data kernel's ring


class BwdPlan(NamedTuple):
    """Launch geometry of one of the backward's kernels."""
    tile: Tuple[int, int]        # (TILE_H, TILE_W) pixels per block
    tiles: Tuple[int, int]       # (tiles over H, tiles over W) per image
    grid: Tuple[int, int]        # (B * tiles, split)
    chunk: int                   # channels per chunk
    split: int                   # ways the channel chunks are split
    chunks_per_split: int        # chunks each split walks
    smem_bytes: int              # dynamic shared memory per block


@functools.lru_cache(maxsize=256)
def bwd_plan(kernel: str, B: int, H: int, W: int, C: int, R: int,
             dtype: torch.dtype, num_sms: int, K: int = 3) -> BwdPlan:
    """Tiles, grid, chunk and shared memory of the backward's `cols`,
    `data` or `coord` kernel.

    Each block owns an 8 x 16 pixel tile of one image and walks the
    channels in chunks of 128 bytes per pixel row (cols, data) or 64
    (coord). cols and coord double-buffer the chunk's x slab (the tile plus a halo
    of K/2 + R) in shared memory, beside cols' per-(pixel, tap) corner
    table or coord's two staged gk boxes. data stages, per tap, the box of
    gk rows its tile of input pixels reads (the tile widened by R) in a
    ring of DATA_STAGES stages, beside a per-(tap, box pixel) table of
    offsets and mask. Where the tiles fill fewer than the card's block
    slots (BWD_BLOCKS_PER_SM per SM), the chunks are split over blockIdx.y
    so that the blocks reach the slots without a second wave (coord's
    splits cost a reduce of their partial tables; cols' and data's write
    disjoint channels).
    """
    if kernel not in BWD_ROW_BYTES:
        raise ValueError(f"unknown backward kernel {kernel!r}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dtype {dtype}: the backward kernels take float32 "
                        "or bfloat16")
    if kernel == "coord" and K != 3:
        raise ValueError(f"K={K}: the coord kernel takes K = 3 (one warp "
                         "per tap)")
    P = K // 2 + R
    slab_px = (TILE_H + 2 * P) * (TILE_W + 2 * P)
    pairs = TILE_H * TILE_W * K * K
    row = BWD_ROW_BYTES[kernel]
    if kernel == "cols":
        smem = 2 * slab_px * row + pairs * (16 + 8)
    elif kernel == "data":  # 1 KB slack, the ring at 1 KB bounds, the table
        box_px = (TILE_H + 2 * R) * (TILE_W + 2 * R)
        smem = (1024 + DATA_STAGES * _cdiv(box_px * row, 1024) * 1024
                + K * K * box_px * 16)
    else:   # 1 KB alignment slack, two stages of TMA boxes at 1 KB bounds
        smem = 1024 + 2 * (_cdiv(slab_px * row, 1024) * 1024 + pairs * row)
    if smem > SMEM_LIMIT:
        raise ValueError(f"K={K}, R={R}: the {kernel} kernel needs {smem} "
                         f"bytes of shared memory, more than {SMEM_LIMIT}")
    chunk = row // (torch.finfo(dtype).bits // 8)
    tiles = (_cdiv(H, TILE_H), _cdiv(W, TILE_W))
    blocks = B * tiles[0] * tiles[1]
    nchunks = _cdiv(C, chunk)
    slots = BWD_BLOCKS_PER_SM[kernel] * num_sms
    cps = nchunks
    if blocks < slots:
        cps = _cdiv(nchunks, min(nchunks, MAX_SPLIT, slots // blocks))
    split = _cdiv(nchunks, cps)
    return BwdPlan(tile=(TILE_H, TILE_W), tiles=tiles, grid=(blocks, split),
                   chunk=chunk, split=split, chunks_per_split=cps,
                   smem_bytes=smem)


def _library():
    global _lib
    if _lib is None:
        from . import _build

        lib = ctypes.CDLL(_build.build(["dcn_shift"])["dcn_shift"][0])
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.dcn_shift_forward_f32.argtypes = [p] * 6 + [i] * 6 + [f, i, p]
        lib.dcn_shift_forward_f32.restype = i
        lib.dcn_shift_forward_bf16.argtypes = ([p] * 7 + [i] * 6
                                               + [f] + [i] * 8 + [p])
        lib.dcn_shift_forward_bf16.restype = i
        lib.dcn_shift_error_string.argtypes = [i]
        lib.dcn_shift_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _bwd_library():
    global _bwd_lib
    if _bwd_lib is None:
        from . import _build

        lib = ctypes.CDLL(_build.build(["dcn_shift_bwd"])["dcn_shift_bwd"][0])
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # pointers, dtype B H W C K, clamp R, then the plan's tiles_y
        # tiles_x split chunks_per_split smem, stream
        for name, n_ptr in (("dcn_shift_bwd_cols", 4),
                            ("dcn_shift_bwd_data", 4),
                            ("dcn_shift_bwd_coord", 7)):
            fn = getattr(lib, name)
            fn.argtypes = [p] * n_ptr + [i] * 6 + [f, i] + [i] * 5 + [p]
            fn.restype = i
        lib.dcn_shift_bwd_error_string.argtypes = [i]
        lib.dcn_shift_bwd_error_string.restype = ctypes.c_char_p
        _bwd_lib = lib
    return _bwd_lib


def num_sms(device: torch.device) -> int:
    """The SM count of a CUDA device, read once per device."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    return _sm_count(idx)


@functools.lru_cache(maxsize=None)
def _sm_count(idx: int) -> int:
    return torch.cuda.get_device_properties(idx).multi_processor_count


def _check(name, t, shape, dtype, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.requires_grad:
        raise ValueError(f"{name} requires grad: the kernel is forward-only")


def dcn_v2_shift_cuda(x, offset, mask, weight, bias=None, *,
                      clamp: float = 1.0):
    """x [B,H,W,C] float32|bfloat16; offset [B,H,W,K*K,2] float32;
    mask [B,H,W,K*K] float32; weight [K,K,C,Cout] in x's dtype;
    bias [Cout] float32 or None. Returns [B,H,W,Cout] in x's dtype.

    Every operand must be contiguous, on one CUDA device and not require
    grad; anything else raises before the kernel is built or launched.
    """
    global launches
    if not isinstance(x, torch.Tensor) or x.dim() != 4:
        raise ValueError("x must be a 4-D tensor [B,H,W,C]")
    if not isinstance(weight, torch.Tensor) or weight.dim() != 4:
        raise ValueError("weight must be a 4-D tensor [K,K,C,Cout]")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x dtype {x.dtype}: the kernel takes float32 or "
                        "bfloat16")
    B, H, W, C = x.shape
    K, K2, Cw, Cout = weight.shape
    if K != K2 or K % 2 == 0 or Cw != C:
        raise ValueError(f"weight {tuple(weight.shape)} for {C} channels: "
                         "needs [K,K,C,Cout] with odd K")
    _, R, _ = shift_geometry(clamp, K)
    if not clamp > 0 or R not in (1, 2):
        raise ValueError(f"clamp {clamp}: the kernel takes 0 < clamp <= 2")
    if B * H * W * Cout == 0:
        raise ValueError(f"empty problem: x {tuple(x.shape)}, Cout {Cout}")
    dev = x.device
    KK = K * K
    _check("x", x, (B, H, W, C), x.dtype, dev)
    _check("offset", offset, (B, H, W, KK, 2), torch.float32, dev)
    _check("mask", mask, (B, H, W, KK), torch.float32, dev)
    _check("weight", weight, (K, K, C, Cout), x.dtype, dev)
    if bias is not None:
        _check("bias", bias, (Cout,), torch.float32, dev)
    if dev.type != "cuda":
        raise ValueError(f"dcn_v2_shift_cuda takes CUDA tensors, got {dev}")
    if bias is None:
        bias = torch.zeros(Cout, dtype=torch.float32, device=dev)

    out = torch.empty((B, H, W, Cout), dtype=x.dtype, device=dev)
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = (x.data_ptr(), offset.data_ptr(), mask.data_ptr(),
            weight.data_ptr(), bias.data_ptr(), out.data_ptr())
    with torch.cuda.device(dev):
        if x.dtype == torch.bfloat16:
            p = plan(B, H, W, C, Cout, R, num_sms(dev), K=K)
            partial = None
            if p.split > 1:
                partial = torch.empty((p.split, B, H, W, Cout),
                                      dtype=torch.float32, device=dev)
            x_vec = C % 8 == 0 and x.data_ptr() % 16 == 0
            w_vec = Cout % 8 == 0 and weight.data_ptr() % 16 == 0
            rc = lib.dcn_shift_forward_bf16(
                *ptrs, None if partial is None else partial.data_ptr(),
                B, H, W, C, Cout, K, float(clamp), R, *p.tiles, p.split,
                p.chunks_per_split, p.smem_bytes, int(x_vec), int(w_vec),
                stream)
        else:
            rc = lib.dcn_shift_forward_f32(*ptrs, B, H, W, C, Cout, K,
                                           float(clamp), R, stream)
    if rc != 0:
        msg = lib.dcn_shift_error_string(rc).decode()
        raise RuntimeError(f"dcn_shift_forward failed: {msg} ({rc})")
    launches += 1
    return out


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _bwd_problem(x_shape, K: int, clamp: float, dtype):
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"dtype {dtype}: the backward kernels take float32 "
                        "or bfloat16")
    B, H, W, C = x_shape
    _, R, _ = shift_geometry(clamp, K)
    if not clamp > 0 or R not in (1, 2):
        raise ValueError(f"clamp {clamp}: the kernels take 0 < clamp <= 2")
    if K % 2 == 0 or B * H * W * C == 0:
        raise ValueError(f"K={K}, x {tuple(x_shape)}: needs odd K and a "
                         "non-empty problem")
    return B, H, W, C, R


def _run(name, *args):
    lib = _bwd_library()
    rc = getattr(lib, name)(*args)
    if rc != 0:
        msg = lib.dcn_shift_bwd_error_string(rc).decode()
        raise RuntimeError(f"{name} failed: {msg} ({rc})")


def _rows16(C: int, *tensors) -> bool:
    """Every row of C channels starts 16-byte aligned (the backward
    kernels' 16-byte copies and stores)."""
    return (C * tensors[0].element_size()) % 16 == 0 and all(
        t.data_ptr() % 16 == 0 for t in tensors)


def _pad_channels(t, rows: int, C: int, C2: int):
    """A fresh [rows, C2] copy of t viewed as [rows, C], zero past C."""
    out = t.new_zeros((rows, C2))
    out[:, :C] = t.reshape(rows, C)
    return out


def dcn_shift_bwd_cols_cuda(x, offset, mask, *, K: int = 3,
                            clamp: float = 1.0):
    """The forward's triangle-weighted columns [B*H*W, K*K*C] in x's dtype
    (x [B,H,W,C]; offset [B,H,W,K*K,2] and mask [B,H,W,K*K] float32)."""
    B, H, W, C, R = _bwd_problem(x.shape, K, clamp, x.dtype)
    KK, dev = K * K, x.device
    _check("x", x, (B, H, W, C), x.dtype, dev)
    _check("offset", offset, (B, H, W, KK, 2), torch.float32, dev)
    _check("mask", mask, (B, H, W, KK), torch.float32, dev)
    if dev.type != "cuda":
        raise ValueError(f"dcn_shift_bwd_cols_cuda takes CUDA tensors, got "
                         f"{dev}")
    C2 = C + -C % (16 // x.element_size())
    if not _rows16(C, x):
        # the kernel takes 16-byte rows: pad C with zero channels, whose
        # columns are cut off again
        x = _pad_channels(x, B * H * W, C, C2).view(B, H, W, C2)
    p = bwd_plan("cols", B, H, W, C2, R, x.dtype, num_sms(dev), K=K)
    col = torch.empty((B * H * W, KK * C2), dtype=x.dtype, device=dev)
    with torch.cuda.device(dev):
        _run("dcn_shift_bwd_cols", x.data_ptr(), offset.data_ptr(),
             mask.data_ptr(), col.data_ptr(), _DTYPE_CODE[x.dtype], B, H, W,
             C2, K, float(clamp), R, *p.tiles, p.split, p.chunks_per_split,
             p.smem_bytes, torch.cuda.current_stream(dev).cuda_stream)
    bwd_launches["cols"] += 1
    if C2 != C:
        col = col.view(B * H * W, KK, C2)[..., :C].reshape(B * H * W, KK * C)
    return col


def dcn_shift_bwd_data_cuda(gk, offset, mask, x_shape, *, K: int = 3,
                            clamp: float = 1.0):
    """dx [B,H,W,C] in gk's dtype from the per-tap cotangent gk
    [B*H*W, K*K*C], in gather form (no atomics)."""
    B, H, W, C, R = _bwd_problem(tuple(x_shape), K, clamp, gk.dtype)
    KK, dev = K * K, gk.device
    _check("gk", gk, (B * H * W, KK * C), gk.dtype, dev)
    _check("offset", offset, (B, H, W, KK, 2), torch.float32, dev)
    _check("mask", mask, (B, H, W, KK), torch.float32, dev)
    if dev.type != "cuda":
        raise ValueError(f"dcn_shift_bwd_data_cuda takes CUDA tensors, got "
                         f"{dev}")
    C2 = C + -C % (16 // gk.element_size())
    if not _rows16(C, gk):
        # the TMA takes 16-byte aligned rows: pad C with zero channels, whose
        # dx is cut off again
        gk = _pad_channels(gk, B * H * W * KK, C, C2).view(B * H * W,
                                                           KK * C2)
    p = bwd_plan("data", B, H, W, C2, R, gk.dtype, num_sms(dev), K=K)
    dx = torch.empty((B, H, W, C2), dtype=gk.dtype, device=dev)
    with torch.cuda.device(dev):
        _run("dcn_shift_bwd_data", gk.data_ptr(), offset.data_ptr(),
             mask.data_ptr(), dx.data_ptr(), _DTYPE_CODE[gk.dtype], B, H, W,
             C2, K, float(clamp), R, *p.tiles, p.split, p.chunks_per_split,
             p.smem_bytes, torch.cuda.current_stream(dev).cuda_stream)
    bwd_launches["data"] += 1
    if C2 != C:
        dx = dx[..., :C].contiguous()
    return dx


def dcn_shift_bwd_coord_cuda(x, gk, offset, mask, *, K: int = 3,
                             clamp: float = 1.0):
    """(doffset [B,H,W,K*K,2], dmask [B,H,W,K*K]) in float32 from x and the
    per-tap cotangent gk [B*H*W, K*K*C], with the reference package's
    subgradient conventions at the triangle and clip kinks. K = 3."""
    B, H, W, C, R = _bwd_problem(x.shape, K, clamp, x.dtype)
    KK, dev = K * K, x.device
    _check("x", x, (B, H, W, C), x.dtype, dev)
    _check("gk", gk, (B * H * W, KK * C), x.dtype, dev)
    _check("offset", offset, (B, H, W, KK, 2), torch.float32, dev)
    _check("mask", mask, (B, H, W, KK), torch.float32, dev)
    if dev.type != "cuda":
        raise ValueError(f"dcn_shift_bwd_coord_cuda takes CUDA tensors, got "
                         f"{dev}")
    if not _rows16(C, x, gk):
        # the TMA takes 16-byte aligned rows: pad C with zero channels, which
        # add nothing to the dot products
        C2 = C + -C % (16 // x.element_size())
        x = _pad_channels(x, B * H * W, C, C2).view(B, H, W, C2)
        gk = _pad_channels(gk, B * H * W * KK, C, C2).view(B * H * W,
                                                           KK * C2)
        C = C2
    p = bwd_plan("coord", B, H, W, C, R, x.dtype, num_sms(dev), K=K)
    doffset = torch.empty((B, H, W, KK, 2), dtype=torch.float32, device=dev)
    dmask = torch.empty((B, H, W, KK), dtype=torch.float32, device=dev)
    partial = None
    if p.split > 1:
        partial = torch.empty((p.split, B * H * W * KK, (2 * R + 1) ** 2),
                              dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _run("dcn_shift_bwd_coord", x.data_ptr(), gk.data_ptr(),
             offset.data_ptr(), mask.data_ptr(), doffset.data_ptr(),
             dmask.data_ptr(), None if partial is None else partial.data_ptr(),
             _DTYPE_CODE[x.dtype], B, H, W, C, K, float(clamp), R, *p.tiles,
             p.split, p.chunks_per_split, p.smem_bytes,
             torch.cuda.current_stream(dev).cuda_stream)
    bwd_launches["coord"] += 1
    return doffset, dmask


def dcn_v2_shift_backward_cuda(x, offset, mask, weight, g, *,
                               clamp: float = 1.0):
    """(dx, doffset, dmask, dweight) of the bias-free shift DCN for the
    output cotangent g [B,H,W,Cout] (x's dtype).

    The products gk = g . W^T and dW = col^T . g run on cuBLAS in x's dtype
    (float32 sums); the column build, dx and the offset/mask gradients are
    the hand-written kernels. dx comes back in x's dtype, doffset and dmask
    in float32, dweight in weight's dtype. The columns are freed before gk
    is formed, so at most one [B*H*W, K*K*C] buffer is live at a time.
    """
    B, H, W, C = x.shape
    K, _, _, Cout = weight.shape
    _check("weight", weight, (K, K, C, Cout), x.dtype, x.device)
    _check("g", g, (B, H, W, Cout), x.dtype, x.device)
    g2 = g.reshape(B * H * W, Cout)
    col = dcn_shift_bwd_cols_cuda(x, offset, mask, K=K, clamp=clamp)
    dweight = torch.matmul(col.t(), g2).reshape(K, K, C, Cout)
    del col
    gk = torch.matmul(g2, weight.reshape(K * K * C, Cout).t())
    dx = dcn_shift_bwd_data_cuda(gk, offset, mask, x.shape, K=K, clamp=clamp)
    doffset, dmask = dcn_shift_bwd_coord_cuda(x, gk, offset, mask, K=K,
                                              clamp=clamp)
    return dx, doffset, dmask, dweight
