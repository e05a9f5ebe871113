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
from m3dssd_tpu_torch.utils.profiling import counts

# one torch thread per test process: the suite runs several workers at
# once, and torch's default of one thread per core made them
# oversubscribe the machine and slow every worker down
torch.set_num_threads(1)


def bwd_launches():
    """The backward kernels' launch counts, by their names in `counts`."""
    return {k: counts[k] for k in ("dcn_shift.bwd.cols",
                                   "dcn_shift.bwd.data",
                                   "dcn_shift.bwd.coord")}


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
    before = counts["dcn_shift.fwd"]
    got = dcn_cuda.dcn_v2_shift_cuda(*args, clamp=clamp)
    want = tdcn.dcn_v2_shift_reference(*args, clamp=clamp)
    torch.cuda.synchronize()
    assert counts["dcn_shift.fwd"] == before + 1
    tol = 1e-4 if dtype == torch.float32 else 6e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    # the public op takes the kernel for CUDA tensors
    torch.testing.assert_close(tdcn.dcn_v2_shift(*args, clamp=clamp), got,
                               rtol=0, atol=0)
    assert counts["dcn_shift.fwd"] == before + 2


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
    before = counts["dcn_shift.fwd"]
    got = dcn_cuda.dcn_v2_shift_cuda(*args, clamp=clamp)
    want = tdcn.dcn_v2_shift_reference(*args, clamp=clamp)
    torch.cuda.synchronize()
    assert counts["dcn_shift.fwd"] == before + 1
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
    before = counts["dcn_shift.fwd"]
    with torch.inference_mode():
        got = card(images.to(cuda_device))
        want = cpu(images)
    assert counts["dcn_shift.fwd"] == before + 8
    for k in ("scores", "bbox_2d", "bbox_3d"):
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=1e-3,
                                   atol=1e-3)


def _rel(a, b):
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp(min=1e-12))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,clamp", [((2, 6, 11, 8, 16), 1.0),
                                         ((1, 5, 11, 40, 72), 1.5),
                                         ((1, 3, 2, 24, 8), 1.5)])
def test_dcn_shift_backward_kernels_match_plain(cuda_device, dtype, shape,
                                                clamp):
    """The three backward kernels and the whole backward against their
    plain versions, with a third of the offsets exactly on a kink (0, +-1,
    +-clamp). float32 sums in another order (1e-4 of the largest
    magnitude); bfloat16 also rounds where the plain version rounds after
    every shifted MAC (5e-2). A 3x2 image is smaller than the R = 2 window.
    Each kernel counts one launch per call."""
    x, off, m, w, _ = _case(21, *shape, dtype, cuda_device, clamp=clamp)
    rng = np.random.default_rng(5)
    kinks = torch.tensor([0.0, 1.0, -1.0, clamp, -clamp], device=cuda_device)
    pick = torch.tensor(rng.random(off.shape) < 0.33, device=cuda_device)
    which = torch.tensor(rng.integers(0, 5, off.shape), device=cuda_device)
    off = torch.where(pick, kinks[which], off).contiguous()
    g = torch.tensor(rng.normal(size=shape[:3] + (shape[4],)),
                     dtype=dtype, device=cuda_device)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    before = bwd_launches()
    got = dcn_cuda.dcn_v2_shift_backward_cuda(x, off, m, w, g, clamp=clamp)
    want = tdcn.dcn_v2_shift_backward_reference(x, off, m, w, g, clamp=clamp)
    torch.cuda.synchronize()
    assert all(counts[k] == before[k] + 1 for k in before)
    for name, a, b in zip(("dx", "doffset", "dmask", "dweight"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert _rel(a, b) <= tol, name
    gk = torch.matmul(g.reshape(-1, shape[4]), w.reshape(-1, shape[4]).t())
    assert _rel(dcn_cuda.dcn_shift_bwd_cols_cuda(x, off, m, clamp=clamp),
                tdcn.shift_columns_reference(x, off, m, clamp=clamp)) <= tol
    assert _rel(dcn_cuda.dcn_shift_bwd_data_cuda(gk, off, m, x.shape,
                                                 clamp=clamp),
                tdcn.shift_dx_reference(gk, off, m, x.shape,
                                        clamp=clamp)) <= tol
    for a, b in zip(dcn_cuda.dcn_shift_bwd_coord_cuda(x, gk, off, m,
                                                      clamp=clamp),
                    tdcn.shift_coord_reference(x, gk, off, m, clamp=clamp)):
        assert _rel(a, b) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,clamp,edge", [
    ((2, 13, 21, 72, 16), 1.0, False),
    ((1, 9, 17, 40, 8), 1.0, True),
    ((1, 9, 17, 40, 8), 1.5, True),
    ((2, 5, 11, 20, 8), 1.0, False),
    ((2, 5, 11, 20, 8), 1.5, False)])
def test_dcn_shift_bwd_tiled_kernels_match_plain(cuda_device, dtype, shape,
                                                 clamp, edge):
    """The three backward kernels (8x16 pixel tiles over rows staged in
    shared memory, see `dcn_cuda.bwd_plan`) against their plain versions:
    13x21 with two images leaves tiles partial in H and W and C = 72 a
    partial channel chunk; `edge` puts every offset exactly on +-clamp (an
    offset at +R takes the corners R-1, R and must stay in the slab; data
    reads knot +-R of a box widened by R); C = 20 (4 mod 8) is no whole
    number of 16-byte bf16 vectors, so the wrappers pad C with zero
    channels. Tolerances as in the test above; each kernel counts one
    launch per call and gives the same bits on a second call (no
    atomics)."""
    B, H, W, C, Co = shape
    x, off, m, w, _ = _case(8, *shape, dtype, cuda_device, clamp=clamp)
    rng = np.random.default_rng(9)
    if edge:
        sign = torch.tensor(rng.integers(0, 2, off.shape) * 2 - 1,
                            dtype=torch.float32, device=cuda_device)
        off = (sign * clamp).contiguous()
    gk = torch.tensor(rng.normal(size=(B * H * W, 9 * C)), dtype=dtype,
                      device=cuda_device)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    before = bwd_launches()
    col = dcn_cuda.dcn_shift_bwd_cols_cuda(x, off, m, clamp=clamp)
    dx = dcn_cuda.dcn_shift_bwd_data_cuda(gk, off, m, x.shape, clamp=clamp)
    coord = dcn_cuda.dcn_shift_bwd_coord_cuda(x, gk, off, m, clamp=clamp)
    torch.cuda.synchronize()
    assert all(counts[k] == before[k] + 1 for k in before)
    assert _rel(col, tdcn.shift_columns_reference(x, off, m,
                                                  clamp=clamp)) <= tol
    assert dx.dtype == dtype and dx.shape == x.shape
    assert _rel(dx, tdcn.shift_dx_reference(gk, off, m, x.shape,
                                            clamp=clamp)) <= tol
    for a, b in zip(coord, tdcn.shift_coord_reference(x, gk, off, m,
                                                      clamp=clamp)):
        assert torch.isfinite(a).all()
        assert _rel(a, b) <= tol
    assert torch.equal(dcn_cuda.dcn_shift_bwd_cols_cuda(x, off, m,
                                                        clamp=clamp), col)
    assert torch.equal(dcn_cuda.dcn_shift_bwd_data_cuda(gk, off, m, x.shape,
                                                        clamp=clamp), dx)
    for a, b in zip(dcn_cuda.dcn_shift_bwd_coord_cuda(x, gk, off, m,
                                                      clamp=clamp), coord):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_tiny_flagship_train_step_on_the_card(cuda_device):
    """A train step of the tiny flagship on the card launches the forward
    kernel and each backward kernel 8 times (the neck's 8 DCN layers) and
    agrees with the same step on the CPU; no plain backward runs on the
    card, and the raw kernel keeps refusing tensors that require grad."""
    from m3dssd_tpu_torch.anchors import locate_anchors
    from m3dssd_tpu_torch.train.state import (create_train_state,
                                              make_train_step)

    conf = flagship_conf((64, 128), num_scales=2, backbone="dla34",
                         dtype="float32").replace(warmup=0.0,
                                                  box_samples=1.0)
    rois = locate_anchors(conf.anchors, conf.feat_size, conf.feat_stride)
    N = rois.shape[0]
    rng = np.random.default_rng(0)
    u = rng.uniform(size=(2, N))
    fg, ign = u < 0.03, u > 0.9
    batch = {"images": torch.tensor(rng.normal(size=(2, 64, 128, 3)),
                                    dtype=torch.float32),
             "labels": torch.tensor(np.where(ign, 3000, np.where(fg, 1, 0)),
                                    dtype=torch.int32),
             "labels_fg": torch.tensor(fg, dtype=torch.int8),
             "labels_bg": torch.tensor(~fg & ~ign, dtype=torch.int8),
             "labels_ign": torch.tensor(ign, dtype=torch.int8),
             "bbox_2d": torch.zeros(2, 4, N), "bbox_3d": torch.zeros(2, 7, N),
             "any_val": torch.ones(2, dtype=torch.int32)}
    losses = {}
    for dev in ("cpu", cuda_device):
        state = create_train_state(conf, build(conf, device=dev, seed=0,
                                               phase="train"), 100)
        before = (counts["dcn_shift.fwd"], bwd_launches())
        losses[str(dev)] = float(make_train_step(conf, rois)(state,
                                                             batch)["loss"])
        if dev != "cpu":
            assert counts["dcn_shift.fwd"] == before[0] + 8
            assert all(counts[k] == before[1][k] + 8
                       for k in before[1])
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-3)
