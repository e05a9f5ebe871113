"""Launch wrapper of the hand-written shift-DCN kernel (csrc/dcn_shift.cu).

The kernel replaces the reference package's TPU kernel
`m3dssd_tpu/ops/dcn_pallas.py:dcn_v2_shift_pallas`; its plain PyTorch
version is `ops/dcn.py:dcn_v2_shift_reference`. Forward only: a tensor that
requires grad is refused.

`launches` counts the kernel's launches; a run resets it to 0 and reads it
back to show that its path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from .dcn import shift_geometry

launches = 0
_lib = None

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _library():
    global _lib
    if _lib is None:
        from . import _build

        lib = ctypes.CDLL(_build.build()[0])
        fn = lib.dcn_shift_forward
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.dcn_shift_error_string.argtypes = [ctypes.c_int]
        lib.dcn_shift_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


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
    if x.dtype not in _DTYPES:
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
    with torch.cuda.device(dev):
        rc = lib.dcn_shift_forward(
            x.data_ptr(), offset.data_ptr(), mask.data_ptr(),
            weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
            B, H, W, C, Cout, K, float(clamp), R, _DTYPES[x.dtype], stream)
    if rc != 0:
        msg = lib.dcn_shift_error_string(rc).decode()
        raise RuntimeError(f"dcn_shift_forward failed: {msg} ({rc})")
    launches += 1
    return out
