"""The greedy NMS op `m3dssd::nms_first_k` (ops/nms_op.py) and its kernel
(csrc/nms.cu) against the plain version, `ops/nms.py:nms_select_t`.

On the CPU: the op's CPU dispatch and fake implementation, `torch.export`
of a small decoder through the op, and a plain PyTorch model of the
kernel's algorithm (compact, sort by (-score, index), scan 32 candidates
at a time with a stop at K, the plain rounds past the capacity) held
against `nms_select_t` and the numpy oracle `py_cpu_nms`.

The tests marked `cuda` hold the kernel against the plain version on the
card, index for index and flag for flag, and need only torch and the port:

    python -m pytest tests/test_torch_nms_kernel.py -m cuda --noconftest \
        -p no:cacheprovider
"""

import math

import pytest
import torch

from chip_smoke import nms_inputs
from m3dssd_tpu_torch.anchors import locate_anchors
from m3dssd_tpu_torch.config import kitti_3d_base
from m3dssd_tpu_torch.inference import detect as detect_mod
from m3dssd_tpu_torch.ops import nms_op
from m3dssd_tpu_torch.ops.nms import nms_select_t, py_cpu_nms
from m3dssd_tpu_torch.utils.profiling import counts
from m3dssd_tpu_torch.utils.synthetic_conf import finalize_conf_synthetic

torch.set_num_threads(1)

INF = float("inf")
# the detect cells' NMS: 48 x 160 positions x 36 anchors, 40 rows
CELL_N, CELL_K, THR, STOP = 48 * 160 * 36, 40, 0.4, 0.75


def _iou_over(a, b, thr):
    """IoU(a, b) > thr for boxes a [4, P] and b [4, Q] -> [P, Q], in the
    plain version's float32 operations and order."""
    x1 = torch.maximum(a[0][:, None], b[0][None])
    y1 = torch.maximum(a[1][:, None], b[1][None])
    x2 = torch.minimum(a[2][:, None], b[2][None])
    y2 = torch.minimum(a[3][:, None], b[3][None])
    area_a = (a[2] - a[0] + 1.0) * (a[3] - a[1] + 1.0)
    area_b = (b[2] - b[0] + 1.0) * (b[3] - b[1] + 1.0)
    inter = (torch.clamp(x2 - x1 + 1.0, min=0.0)
             * torch.clamp(y2 - y1 + 1.0, min=0.0))
    return inter / (area_a[:, None] + area_b[None] - inter) > thr


def kernel_model(boxes_t, scores, thr, K, stop=None, cap=nms_op.CAP):
    """csrc/nms.cu's algorithm in plain PyTorch, image by image."""
    B, _, N = boxes_t.shape
    scores = scores.to(torch.float32)
    idx = torch.zeros((B, K), dtype=torch.int64)
    valid = torch.zeros((B, K), dtype=torch.bool)
    floor = torch.tensor(-INF if stop is None else stop, dtype=torch.float32)
    ninf = torch.tensor(-INF)
    rest = bool(ninf >= floor) if stop is not None else False
    for b in range(B):
        s, bx = scores[b], boxes_t[b]
        nan = torch.isnan(s).nonzero()[:, 0]
        if len(nan):               # the plain version picks a NaN each round
            idx[b] = 0 if stop is not None else nan[0]
            continue
        cand = ((s > -INF) & (s >= floor)).nonzero()[:, 0]
        if len(cand) > cap:                 # the rounds, run on the card
            i, v = nms_select_t(bx[None], s[None], thr, K, stop_below=stop)
            idx[b], valid[b] = i[0], v[0]
            continue
        order = cand[torch.argsort(-s[cand], stable=True)]
        cb = bx[:, order]
        kept = []
        for base in range(0, len(order), 32):
            if len(kept) == K:
                break
            chunk = cb[:, base:base + 32]
            live = torch.ones(chunk.shape[1], dtype=torch.bool)
            if kept:
                live = ~_iou_over(cb[:, kept], chunk, thr).any(0)
            over = _iou_over(chunk, chunk, thr)
            taken = []
            for i in range(chunk.shape[1]):
                if len(kept) + len(taken) == K:
                    break
                if live[i] and not any(bool(over[t, i]) for t in taken):
                    taken.append(i)
            kept += [base + t for t in taken]
        idx[b, :len(kept)] = order[kept]
        valid[b, :len(kept)] = True
        valid[b, len(kept):] = rest
    return idx, valid


def _boundary_case(thr, per_target=3, seed=0):
    """One image of box pairs whose IoU, in the plain version's float32
    arithmetic, is one float32 step below, equal to and one step above
    thr; the first box of a pair scores higher. Far apart pairs; returns
    (boxes [1,4,N], scores [1,N], the IoU step of each pair: -1, 0, 1)."""
    gen = torch.Generator().manual_seed(seed)
    t = torch.tensor(thr, dtype=torch.float32)
    targets = [torch.nextafter(t, torch.tensor(-INF)), t,
               torch.nextafter(t, torch.tensor(INF))]
    M = 200000
    cell = torch.randint(0, 400, (M,), generator=gen)
    X = (cell % 20).to(torch.float32) * 400
    Y = (cell // 20).to(torch.float32) * 400
    w = 20 + torch.rand(M, generator=gen, dtype=torch.float64) * 280
    h = 20 + torch.rand(M, generator=gen, dtype=torch.float64) * 280
    w2 = thr * (w + 1) - 1 + (torch.rand(M, generator=gen,
                                         dtype=torch.float64) - 0.5) * 1e-5
    a = torch.stack([X, Y, X + w.float(), Y + h.float()])
    b = torch.stack([X, Y, X + w2.float(), Y + h.float()])
    x1 = torch.maximum(a[0], b[0])
    x2 = torch.minimum(a[2], b[2])
    y1 = torch.maximum(a[1], b[1])
    y2 = torch.minimum(a[3], b[3])
    area_a = (a[2] - a[0] + 1.0) * (a[3] - a[1] + 1.0)
    area_b = (b[2] - b[0] + 1.0) * (b[3] - b[1] + 1.0)
    inter = (torch.clamp(x2 - x1 + 1.0, min=0.0)
             * torch.clamp(y2 - y1 + 1.0, min=0.0))
    iou = inter / (area_a + area_b - inter)
    picked, steps, used = [], [], set()
    for step, target in zip((-1, 0, 1), targets):
        hits = (iou == target).nonzero()[:, 0].tolist()
        n = 0
        for i in hits:
            if int(cell[i]) in used:
                continue
            used.add(int(cell[i]))
            picked.append(i)
            steps.append(step)
            n += 1
            if n == per_target:
                break
        assert n == per_target, f"no IoU at {step} steps from {thr}"
    p = torch.tensor(picked)
    boxes = torch.cat([a[:, p], b[:, p]], 1)[None]
    n = len(picked)
    scores = torch.cat([torch.full((n,), 0.9), torch.full((n,), 0.8)])[None]
    return boxes.contiguous(), scores, torch.tensor(steps)


def _cases():
    """(name, boxes, scores, thr, K, stop, cap) on the CPU."""
    seeds = iter(range(10, 100))

    def _clustered(B, N, cand, ties=False):
        return nms_inputs(B, N, cand, STOP, next(seeds), "cpu", ties=ties)

    out = []
    b, s = _clustered(3, 2000, (5, 300))
    out.append(("clustered", b, s, THR, 40, STOP, nms_op.CAP))
    b, s = _clustered(3, 2000, (20, 300), ties=True)
    b[:, :, 7] = b[:, :, 3]                       # two identical boxes
    s[:, 7] = s[:, 3]
    out.append(("ties", b, s, THR, 40, STOP, nms_op.CAP))
    b, s = _clustered(2, 500, (0, 0))
    out.append(("no_candidates", b, s, THR, 40, STOP, nms_op.CAP))
    b, s = _clustered(2, 10, (3, 10))
    out.append(("n_below_k", b, s, THR, 40, STOP, nms_op.CAP))
    b, s = _clustered(1, 1500, (5, 300))
    out.append(("one_image", b, s, THR, 40, STOP, nms_op.CAP))
    b, s = _clustered(2, 600, (5, 300))
    s[1, ::5] = -INF
    out.append(("no_stop", b, s, THR, 40, None, nms_op.CAP))
    out.append(("no_stop_overflow", b, s, THR, 40, None, 64))
    b, s = _clustered(3, 1000, (40, 300))
    out.append(("overflow", b, s, THR, 40, STOP, 16))
    out.append(("k_past_candidates", b, s, THR, 400, STOP, nms_op.CAP))
    b, s = _clustered(3, 300, (5, 100))
    s[1, 17] = float("nan")
    s[1, 40] = float("nan")
    out.append(("nan", b, s, THR, 20, STOP, nms_op.CAP))
    out.append(("nan_no_stop", b, s, THR, 20, None, nms_op.CAP))
    b, s = _clustered(2, 300, (5, 100))
    s[:, ::7] = -INF
    out.append(("floor_at_minus_inf", b, s, THR, 80, -INF, nms_op.CAP))
    b, s, _ = _boundary_case(THR)
    out.append(("iou_one_step_from_thr", b, s, THR, 40, STOP, nms_op.CAP))
    return out


CASES = _cases()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_kernel_model_matches_plain(case):
    _, boxes, scores, thr, K, stop, cap = case
    want = nms_select_t(boxes, scores, thr, K, stop_below=stop)
    got = kernel_model(boxes, scores, thr, K, stop=stop, cap=cap)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("seed", range(4))
def test_kernel_model_matches_py_cpu_nms(seed):
    """Without ties, the model's rows are the numpy oracle's kept boxes at
    or above the stop, in its order, cut at K."""
    boxes, scores = nms_inputs(2, 3000, (5, 600), STOP, 100 + seed, "cpu")
    K = 25
    idx, valid = kernel_model(boxes, scores, THR, K, stop=STOP)
    for b in range(2):
        dets = torch.cat([boxes[b].T, scores[b][:, None]], 1).numpy()
        keep = [i for i in py_cpu_nms(dets, THR) if dets[i, 4] >= STOP][:K]
        n = int(valid[b].sum())
        assert idx[b, :n].tolist() == keep
        assert not valid[b, n:].any() and not idx[b, n:].any()


def test_boundary_case_straddles_the_threshold():
    """The pairs at one step above the threshold lose their second box,
    the others keep it."""
    boxes, scores, steps = _boundary_case(THR)
    n = len(steps)
    idx, valid = nms_select_t(boxes, scores, THR, 2 * n, stop_below=STOP)
    kept = set(idx[0][valid[0]].tolist())
    assert kept == set(range(n)) | {n + i for i in range(n)
                                    if steps[i] <= 0}


@pytest.mark.parametrize("case", CASES[:8], ids=[c[0] for c in CASES[:8]])
def test_op_cpu_dispatch_is_the_plain_version(case):
    _, boxes, scores, thr, K, stop, _ = case
    got = nms_op.nms_first_k(boxes, scores, thr, K, stop)
    want = nms_select_t(boxes, scores, thr, K, stop_below=stop)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[0].dtype == torch.int64 and got[1].dtype == torch.bool


@pytest.mark.parametrize("stop", [STOP, None])
def test_op_schema_and_fake(stop):
    """opcheck holds, and the fake implementation gives the shapes and
    dtypes without computing."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    _, boxes, scores, *_ = CASES[0]
    torch.library.opcheck(nms_op.nms_first_k, (boxes, scores, THR, 7, stop))
    with FakeTensorMode() as mode:
        fb = mode.from_tensor(boxes)
        fs = mode.from_tensor(scores)
        idx, valid = nms_op.nms_first_k(fb, fs, THR, 7, stop)
    assert idx.shape == (3, 7) and idx.dtype == torch.int64
    assert valid.shape == (3, 7) and valid.dtype == torch.bool


def test_op_registration_is_guarded():
    """A second copy of the op module leaves the one registration."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "m3dssd_tpu_torch.ops.nms_op_copy", nms_op.__file__)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.nms_first_k is nms_op.nms_first_k


def _base_decoder(crop=(64, 224)):
    conf = finalize_conf_synthetic(kitti_3d_base().replace(
        crop_size=list(crop), test_scale=list(crop), num_anchor_scales=2,
        back_bone="dla34", pre_train=False, compute_dtype="float32"))
    rois = locate_anchors(conf.anchors, conf.feat_size, conf.feat_stride)
    return detect_mod._Decoder(conf, rois, torch.device("cpu")), rois


def test_decoder_exports_through_the_op():
    """A decoder exported with torch.export calls m3dssd::nms_first_k by
    name, and its tables equal the eager decoder's."""
    dec, rois = _base_decoder()
    N = rois.shape[0]

    class Dec(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.dec = dec

        def forward(self, scores, cls_pred, d2, d3, sfs):
            return self.dec({"scores": scores, "cls_pred": cls_pred,
                             "bbox_2d": d2, "bbox_3d": d3}, sfs)

    def inputs(seed):
        g = torch.Generator().manual_seed(seed)
        return (torch.rand(2, N, generator=g),
                torch.randint(1, 4, (2, N), generator=g),
                torch.randn(2, 4, N, generator=g) * 0.3,
                torch.randn(2, 7, N, generator=g) * 0.3,
                torch.tensor([1.0, 0.8]))

    ep = torch.export.export(Dec(), inputs(0), strict=False)
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert any("nms_first_k" in t for t in targets)
    for seed in (1, 2):
        args = inputs(seed)
        want = Dec()(*args)
        assert (want[..., 4] >= 0).any()
        assert torch.equal(ep.module()(*args), want)


# -- on the card ----------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _on_card(boxes, scores, thr, K, stop):
    """(kernel, plain) results on the card, the kernel's launch counted."""
    before = counts["nms.kernel"]
    got = nms_op.nms_first_k(boxes, scores, thr, K, stop)
    assert counts["nms.kernel"] == before + 1
    want = nms_select_t(boxes, scores, thr, K, stop_below=stop)
    torch.cuda.synchronize()
    return got, want


def _assert_same(got, want):
    assert torch.equal(got[0], want[0]), (got[0], want[0])
    assert torch.equal(got[1], want[1]), (got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("ties", [False, True])
def test_card_cells_shape(card, ties):
    """B=64, N=276,480, K=40, stop 0.75, 5-600 candidates an image: the
    fast path alone (the tally reads 0), bit for bit the plain version."""
    boxes, scores = nms_inputs(64, CELL_N, (5, 600), STOP, 3 + ties, card,
                               ties=ties)
    nms_op.reset_overflow_tally(card)
    got, want = _on_card(boxes, scores, THR, CELL_K, STOP)
    _assert_same(got, want)
    assert nms_op.overflow_tally(card) == 0
    assert int(want[1].sum()) > 64


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_card_cases(card, case):
    """The CPU cases on the card: ties, IoUs one float32 step from the
    threshold, no candidates, N < K, B=1, no stop, NaN, floor -inf."""
    _, boxes, scores, thr, K, stop, _ = case
    got, want = _on_card(boxes.to(card), scores.to(card), thr, K, stop)
    _assert_same(got, want)
    cpu = nms_select_t(boxes, scores, thr, K, stop_below=stop)
    assert torch.equal(got[0].cpu(), cpu[0])
    assert torch.equal(got[1].cpu(), cpu[1])


@pytest.mark.cuda
@pytest.mark.parametrize("stop", [STOP, None])
def test_card_overflow_takes_the_rounds(card, stop):
    """More than CAP candidates an image: every image runs the exact
    rounds on the card, and the tally reads 1 an image."""
    B, N = 4, 20000 if stop is None else CELL_N
    boxes, scores = nms_inputs(B, N, (nms_op.CAP + 1, nms_op.CAP + 900),
                               STOP, 9, card)
    nms_op.reset_overflow_tally(card)
    got, want = _on_card(boxes, scores, THR, CELL_K, stop)
    _assert_same(got, want)
    assert nms_op.overflow_tally(card) == B


@pytest.mark.cuda
def test_card_no_stop_fast_path(card):
    """No stop over 3,000 anchors (make_detector's top-k pre-NMS cut):
    every anchor a candidate, still within CAP."""
    boxes, scores = nms_inputs(3, 3000, (5, 300), STOP, 5, card)
    nms_op.reset_overflow_tally(card)
    got, want = _on_card(boxes, scores, THR, CELL_K, None)
    _assert_same(got, want)
    assert nms_op.overflow_tally(card) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("background", [None, 4.0])
def test_card_flagship_table_equals_the_plain_path(card, background,
                                                   monkeypatch):
    """A bs=8 flagship table through make_batch_detector is torch.equal to
    the table of the same detector with the plain NMS, padding rows
    included; one kernel launch a call."""
    from m3dssd_tpu_torch.config import flagship_conf
    from m3dssd_tpu_torch.models import bias_background, build

    conf = flagship_conf((384, 1280))
    model = build(conf, seed=0)
    if background is not None:
        bias_background(model, conf.num_classes, background)
    rois = locate_anchors(conf.anchors, conf.feat_size, conf.feat_stride)
    det = detect_mod.make_batch_detector(conf, rois, model)
    gen = torch.Generator(device=card).manual_seed(2)
    images = torch.randn((8, 384, 1280, 3), generator=gen, device=card)
    sfs = torch.ones(8, device=card)
    before = counts["nms.kernel"]
    got = det(images, sfs)
    assert counts["nms.kernel"] == before + 1
    monkeypatch.setattr(
        detect_mod, "nms_first_k",
        lambda b, s, t, k, stop: nms_select_t(b, s, t, k, stop_below=stop))
    want = det(images, sfs)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert got.shape == (8, conf.nms_topN_post, 14)
    assert math.isfinite(float(got.abs().max()))
