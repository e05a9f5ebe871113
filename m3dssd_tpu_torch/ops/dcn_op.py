"""The shift-DCN forward as a `torch.library` custom op,
`m3dssd::dcn_shift(x, offset, mask, weight, bias?, clamp) -> Tensor`.

Behind one op name the forward runs on the card as the hand-written kernel
(`ops/dcn_cuda.py:dcn_v2_shift_cuda`, which counts its launches) and on
the CPU as the plain version (`ops/dcn.py:dcn_v2_shift_reference`). The
fake implementation gives the output's shape and dtype without computing,
so `torch.export` traces the detector through the op and the exported
program calls it by name. A process that only loads an exported artifact
imports this module, so it imports nothing but torch and the port's ops.

Operands as `dcn_v2_shift_cuda` takes them: x [B,H,W,C] float32 or
bfloat16, offset [B,H,W,K*K,2] and mask [B,H,W,K*K] float32, weight
[K,K,C,Cout] in x's dtype, bias [Cout] float32 or None; out [B,H,W,Cout]
in x's dtype. The op has no autograd formula: training reaches the kernels
through `ops/dcn.py:DCNShiftFunction`, which calls the op in its forward.

Registering one name twice raises, and a second copy of the package (a
run's source snapshot, imported in the same process) would do that, so the
registration is skipped when the name exists; the op then runs the first
copy's implementations.
"""

from __future__ import annotations

from typing import Optional

import torch

NAME = "m3dssd::dcn_shift"


def _registered() -> bool:
    try:
        torch.ops.m3dssd.dcn_shift.default
    except (AttributeError, RuntimeError):
        return False
    return True


def _cuda(x, offset, mask, weight, bias, clamp):
    from .dcn_cuda import dcn_v2_shift_cuda

    return dcn_v2_shift_cuda(
        x.detach().contiguous(), offset.detach().contiguous(),
        mask.detach().contiguous(), weight.detach().contiguous(),
        None if bias is None else bias.detach().contiguous(), clamp=clamp)


def _cpu(x, offset, mask, weight, bias, clamp):
    from .dcn import dcn_v2_shift_reference

    return dcn_v2_shift_reference(x, offset, mask, weight, bias,
                                  clamp=clamp).contiguous()


def _fake(x, offset, mask, weight, bias, clamp):
    B, H, W, _ = x.shape
    return x.new_empty((B, H, W, weight.shape[-1]))


if not _registered():
    @torch.library.custom_op(NAME, mutates_args=())
    def _dcn_shift(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                   weight: torch.Tensor, bias: Optional[torch.Tensor],
                   clamp: float) -> torch.Tensor:
        raise NotImplementedError(f"{NAME} on {x.device}")

    _dcn_shift.register_kernel("cuda")(_cuda)
    _dcn_shift.register_kernel("cpu")(_cpu)
    _dcn_shift.register_fake(_fake)

dcn_shift = torch.ops.m3dssd.dcn_shift
