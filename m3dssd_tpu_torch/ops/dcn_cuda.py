"""Launch wrapper of the hand-written shift-DCN kernels (csrc/dcn_shift.cu).

The kernels replace the reference package's TPU kernel
`m3dssd_tpu/ops/dcn_pallas.py:dcn_v2_shift_pallas`; their plain PyTorch
version is `ops/dcn.py:dcn_v2_shift_reference`. Forward only: a tensor that
requires grad is refused.

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
_lib = None

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


def _library():
    global _lib
    if _lib is None:
        from . import _build

        lib = ctypes.CDLL(_build.build()[0])
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
