"""The port's hand-written CUDA kernel against its plain PyTorch version.

These tests need a CUDA card (marked `cuda`) and skip without one. They
import only torch, numpy and the port, so they also run where JAX is not
installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest \
        -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from m3dssd_tpu_torch.config import flagship_conf
from m3dssd_tpu_torch.models import build
from m3dssd_tpu_torch.models.necks import DCN
from m3dssd_tpu_torch.ops import dcn as tdcn
from m3dssd_tpu_torch.ops import dcn_cuda


@pytest.fixture
def cuda_device():
    """The card with TF32 off, or a skip on a machine without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(seed, B, H, W, C, Co, dtype, dev, clamp=1.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H, W, C))
    off = rng.normal(size=(B, H, W, 9, 2)) * 1.2 * clamp  # spans +-clamp
    off[0, 0, 0, 0] = (clamp, -clamp)                 # exactly on the clamp
    m = rng.random((B, H, W, 9))
    w = rng.normal(size=(3, 3, C, Co)) / np.sqrt(9 * C)
    b = rng.normal(size=(Co,))
    f = lambda a, dt=torch.float32: torch.tensor(a, dtype=dt, device=dev)
    return f(x, dtype), f(off), f(m), f(w, dtype), f(b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,clamp", [((2, 6, 11, 8, 16), 1.0),
                                         ((1, 5, 11, 40, 72), 1.0),
                                         ((1, 12, 40, 64, 130), 1.0),
                                         ((1, 5, 11, 40, 72), 1.5)])
def test_dcn_shift_kernel_matches_plain(cuda_device, dtype, shape, clamp):
    """float32: the CUDA-core kernel sums in another order (1e-4).
    bfloat16: the plain version rounds each shifted MAC to bf16 and the
    tensor-core kernel rounds each 4-corner column once, so they differ by
    bf16 rounding at unit scale (6e-2). W = 11 leaves a ragged pixel tile;
    C = 40 and Cout = 72, 130 leave ragged channel chunks (Cout = 130 rows
    are not 16-byte aligned); clamp 1.5 runs the R = 2 form."""
    args = _case(11, *shape, dtype, cuda_device, clamp=clamp)
    before = dcn_cuda.launches
    got = dcn_cuda.dcn_v2_shift_cuda(*args, clamp=clamp)
    want = tdcn.dcn_v2_shift_reference(*args, clamp=clamp)
    torch.cuda.synchronize()
    assert dcn_cuda.launches == before + 1
    tol = 1e-4 if dtype == torch.float32 else 6e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    # the public op takes the kernel for CUDA tensors
    torch.testing.assert_close(tdcn.dcn_v2_shift(*args, clamp=clamp), got,
                               rtol=0, atol=0)
    assert dcn_cuda.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("shape,clamp", [((1, 12, 40, 1024, 512), 1.0),
                                         ((1, 13, 41, 64, 72), 1.0),
                                         ((1, 13, 41, 200, 72), 1.5)])
def test_dcn_shift_bf16_kernel_split_and_ragged_tiles(cuda_device, shape,
                                                      clamp):
    """1x12x40, 1024->512 fills too few blocks for the card, so the plan
    splits its reduction; 13x41 is no multiple of the 8x16 pixel tile;
    C = 200 ends in a partial 64-channel chunk. One call of the op counts
    one launch, with or without the split's reduce kernel."""
    B, H, W, C, Co = shape
    args = _case(3, *shape, torch.bfloat16, cuda_device, clamp=clamp)
    p = dcn_cuda.plan(B, H, W, C, Co, 2 if clamp > 1 else 1,
                      dcn_cuda.num_sms(cuda_device))
    if shape[3] == 1024:
        assert p.split > 1
    before = dcn_cuda.launches
    got = dcn_cuda.dcn_v2_shift_cuda(*args, clamp=clamp)
    want = tdcn.dcn_v2_shift_reference(*args, clamp=clamp)
    torch.cuda.synchronize()
    assert dcn_cuda.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), rtol=6e-2,
                               atol=6e-2)
    # the split reduction sums in a fixed order: the same bits every call
    assert torch.equal(dcn_cuda.dcn_v2_shift_cuda(*args, clamp=clamp), got)


@pytest.mark.cuda
def test_dcn_shift_kernel_refuses_grad_and_wrong_layout(cuda_device):
    x, off, m, w, b = _case(2, 1, 4, 5, 8, 8, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="requires grad"):
        dcn_cuda.dcn_v2_shift_cuda(x.requires_grad_(), off, m, w, b)
    with pytest.raises(ValueError, match="contiguous"):
        dcn_cuda.dcn_v2_shift_cuda(x.detach().transpose(1, 2).contiguous()
                                   .transpose(1, 2), off, m, w, b)


@pytest.mark.cuda
def test_tiny_flagship_neck_runs_the_kernel_eight_times(cuda_device):
    """The model's 8 neck DCN layers launch the kernel once each per
    forward, and the card agrees with the CPU run of the same weights."""
    conf = flagship_conf((64, 128), num_scales=2, backbone="dla34",
                         dtype="float32")
    cpu = build(conf, device="cpu", seed=0)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for mod in cpu.modules():
            if isinstance(mod, DCN):
                w = mod.conv_offset_mask.weight
                w.copy_(torch.randn(w.shape, generator=g) * 0.05)
    card = build(conf, device=cuda_device, seed=0)
    card.load_state_dict(cpu.state_dict())
    images = torch.randn(2, 64, 128, 3, generator=g)
    before = dcn_cuda.launches
    with torch.inference_mode():
        got = card(images.to(cuda_device))
        want = cpu(images)
    assert dcn_cuda.launches == before + 8
    for k in ("scores", "bbox_2d", "bbox_3d"):
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=1e-3,
                                   atol=1e-3)
