"""Greedy first-k NMS as a `torch.library` custom op,
`m3dssd::nms_first_k(boxes_t, scores, iou_thresh, num_out, stop_below?)
-> (idx, valid)`.

Behind one op name it runs on the card as the hand-written kernel
(csrc/nms.cu, launched by `nms_first_k_cuda`, which counts its launches as
`nms.kernel`) and on the CPU as the plain version
(`ops/nms.py:nms_select_t`). Both return the same indices and flags. The
fake implementation gives the output shapes, so `torch.export` traces the
detector through the op and the exported program calls it by name; a
process that loads such a program imports this module.

Operands: boxes_t [B, 4, N] float32, scores [B, N] (taken as float32);
out idx [B, num_out] int64 and valid [B, num_out] bool. Semantics as
`nms_select_t`'s: greedy in order of score (lower index first among equal
scores), suppression where IoU > iou_thresh, a row valid while its score
is >= stop_below (without one, > -inf), unused slots valid=False at index 0.

The kernel takes the first `CAP` candidates an image (scores above the
floor) on its fast path and runs the plain version's rounds on the card
for an image with more; `overflow_tally` reads how many images did that
(a read-back, for tests and smoke runs, never on the detect path).

Registering one name twice raises, and a second copy of the package would
do that, so the registration is skipped when the name exists (as in
`ops/dcn_op.py`).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..utils.profiling import count

NAME = "m3dssd::nms_first_k"
CAP = 4096                  # candidates an image the fast path sorts

_lib = None
_tally = {}                 # device -> int32 [1] of images on the rounds path


def _library():
    global _lib
    if _lib is None:
        from . import _build

        lib = ctypes.CDLL(_build.build(["nms"])["nms"][0])
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.nms_first_k.argtypes = [p, p, i, i, i, f, i, f] + [p] * 7
        lib.nms_first_k.restype = i
        lib.nms_error_string.argtypes = [i]
        lib.nms_error_string.restype = ctypes.c_char_p
        for name in ("nms_capacity", "nms_max_out"):
            getattr(lib, name).restype = i
        if lib.nms_capacity() != CAP:
            raise RuntimeError(f"csrc/nms.cu takes {lib.nms_capacity()} "
                               f"candidates an image, ops/nms_op.py {CAP}")
        _lib = lib
    return _lib


def _tally_of(device: torch.device) -> torch.Tensor:
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    if device not in _tally:
        # a normal tensor, though the first launch may run in inference mode
        with torch.inference_mode(False):
            _tally[device] = torch.zeros(1, dtype=torch.int32, device=device)
    return _tally[device]


def overflow_tally(device) -> int:
    """Images on `device` that took the kernel's rounds path since the
    last reset (reads the device back)."""
    return int(_tally_of(torch.device(device)).item())


def reset_overflow_tally(device) -> None:
    _tally_of(torch.device(device)).zero_()


def nms_first_k_cuda(boxes_t, scores, iou_thresh: float, num_out: int,
                     stop_below: Optional[float] = None):
    """The kernel on CUDA tensors: boxes_t [B, 4, N] float32, scores
    [B, N]. Raises on anything else before it builds or launches."""
    if boxes_t.dim() != 3 or boxes_t.shape[1] != 4:
        raise ValueError(f"boxes_t {tuple(boxes_t.shape)}: needs [B, 4, N]")
    B, _, N = boxes_t.shape
    if tuple(scores.shape) != (B, N):
        raise ValueError(f"scores {tuple(scores.shape)} for boxes_t "
                         f"{tuple(boxes_t.shape)}")
    if boxes_t.dtype != torch.float32:
        raise TypeError(f"boxes_t has dtype {boxes_t.dtype}: the kernel "
                        "takes float32")
    dev = boxes_t.device
    if dev.type != "cuda" or scores.device != dev:
        raise ValueError(f"nms_first_k_cuda takes CUDA tensors on one "
                         f"device, got {dev} and {scores.device}")
    if not 0 < N < 2 ** 31 - 2 ** 16 or not 0 < B <= 65535:
        raise ValueError(f"B={B}, N={N}: the kernel takes 0 < B <= 65535 "
                         "and 0 < N < 2**31 - 65536")
    idx = torch.empty((B, num_out), dtype=torch.int64, device=dev)
    valid = torch.empty((B, num_out), dtype=torch.bool, device=dev)
    if num_out == 0:
        return idx, valid
    lib = _library()
    if not 0 < num_out <= lib.nms_max_out():
        raise ValueError(f"num_out {num_out}: the kernel keeps at most "
                         f"{lib.nms_max_out()} rows an image")
    boxes_t = boxes_t.detach().contiguous()
    scores = scores.detach().to(torch.float32).contiguous()
    keys = torch.empty((B, CAP), dtype=torch.int64, device=dev)
    counters = torch.empty((2, B), dtype=torch.int32, device=dev)
    scratch = torch.empty((B, N), dtype=torch.float32, device=dev)
    has_stop = stop_below is not None
    with torch.cuda.device(dev):
        rc = lib.nms_first_k(
            boxes_t.data_ptr(), scores.data_ptr(), B, N, num_out,
            float(iou_thresh), int(has_stop),
            float(stop_below) if has_stop else float("-inf"),
            keys.data_ptr(), counters.data_ptr(), scratch.data_ptr(),
            idx.data_ptr(), valid.data_ptr(), _tally_of(dev).data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        msg = lib.nms_error_string(rc).decode()
        raise RuntimeError(f"nms_first_k failed: {msg} ({rc})")
    count("nms.kernel")
    return idx, valid


def _cpu(boxes_t, scores, iou_thresh, num_out, stop_below):
    from .nms import nms_select_t

    return nms_select_t(boxes_t, scores, iou_thresh, num_out,
                        stop_below=stop_below)


def _fake(boxes_t, scores, iou_thresh, num_out, stop_below):
    B = boxes_t.shape[0]
    return (boxes_t.new_empty((B, num_out), dtype=torch.int64),
            boxes_t.new_empty((B, num_out), dtype=torch.bool))


def _registered() -> bool:
    try:
        torch.ops.m3dssd.nms_first_k.default
    except (AttributeError, RuntimeError):
        return False
    return True


if not _registered():
    @torch.library.custom_op(NAME, mutates_args=())
    def _nms_first_k(boxes_t: torch.Tensor, scores: torch.Tensor,
                     iou_thresh: float, num_out: int,
                     stop_below: Optional[float]
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError(f"{NAME} on {boxes_t.device}")

    _nms_first_k.register_kernel("cuda")(nms_first_k_cuda)
    _nms_first_k.register_kernel("cpu")(_cpu)
    _nms_first_k.register_fake(_fake)

nms_first_k = torch.ops.m3dssd.nms_first_k
