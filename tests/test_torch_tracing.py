"""The port's program spans and counts (`utils/profiling.py`) on the detect
path: off without a profiler, the same tables with one, the span names and
their nesting, one `sync.<site>` count a read-back, the dense fallback's
count and span, and no profiler op in an exported program.

The CPU tests run a tiny detector (DLA-34 at 64x224, float32). The test
marked `cuda` runs the flagship at 384x1280 bs=8 on the card, where every
host sync raises a warning under `torch.cuda.set_sync_debug_mode("warn")`
except the pacing's event wait (`sync.detect.inflight`), which the test
counts apart, and needs only torch and the port:

    python -m pytest tests/test_torch_tracing.py -m cuda --noconftest \
        -p no:cacheprovider
"""

import warnings
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from m3dssd_tpu_torch.anchors import locate_anchors
from m3dssd_tpu_torch.config import flagship_conf, kitti_3d_base
from m3dssd_tpu_torch.inference.detect import make_batch_detector
from m3dssd_tpu_torch.inference.export import export_detector
from m3dssd_tpu_torch.models import bias_background, build
from m3dssd_tpu_torch.ops import control
from m3dssd_tpu_torch.utils import profiling
from m3dssd_tpu_torch.utils.synthetic_conf import finalize_conf_synthetic

torch.set_num_threads(1)

CROP = (64, 224)
B = 2
# each span's parent, the innermost program span around it on the thread
PARENTS = {
    "m3dssd.backbone": "m3dssd.detect",
    "m3dssd.head": "m3dssd.detect",
    "m3dssd.align.select": "m3dssd.head",
    "m3dssd.align.shape": "m3dssd.head",
    "m3dssd.align.center2d": "m3dssd.head",
    "m3dssd.align.center3d": "m3dssd.head",
    "m3dssd.sync.align.shape": "m3dssd.align.shape",
    "m3dssd.sync.align.center2d": "m3dssd.align.center2d",
    "m3dssd.sync.align.center3d": "m3dssd.align.center3d",
    "m3dssd.anab": "m3dssd.head",
    "m3dssd.decode_nms": "m3dssd.detect",
    "m3dssd.compact": "m3dssd.decode_nms",
    "m3dssd.sync.decode.sparse": "m3dssd.decode_nms",
    "m3dssd.decode": "m3dssd.decode_nms",
    "m3dssd.nms": "m3dssd.decode_nms",
    "m3dssd.nms.round": "m3dssd.nms",
    "m3dssd.sync.nms.fixpoint": "m3dssd.nms",
    "m3dssd.sync.detect.inflight": "m3dssd.detect",
    "m3dssd.table": "m3dssd.decode_nms",
}


def _conf(kind, **replace):
    """The tiny fullalign detector with the sparse pre-NMS path on, or the
    tiny base detector with the dense decode."""
    if kind == "fullalign":
        conf = flagship_conf(CROP, num_scales=2, backbone="dla34",
                             dtype="float32")
        return conf.replace(nms_sparse_topm=64, **replace)
    return finalize_conf_synthetic(kitti_3d_base().replace(
        crop_size=list(CROP), test_scale=list(CROP), num_anchor_scales=2,
        back_bone="dla34", pre_train=False, compute_dtype="float32",
        **replace))


def _detector(conf, seed=0):
    model = build(conf, device="cpu", seed=seed)
    rois = locate_anchors(conf.anchors, conf.feat_size, conf.feat_stride)
    return make_batch_detector(conf, rois, model, device="cpu")


def _images(seed=1):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((B,) + CROP + (3,), generator=gen), torch.ones(B)


@pytest.fixture(scope="module")
def detectors():
    return {kind: _detector(_conf(kind)) for kind in ("fullalign", "base")}


def _spans(prof):
    """[(name, start, end, thread)] of the program's spans in a profile."""
    return [(e.name, e.time_range.start, e.time_range.end, e.thread)
            for e in prof.events() if e.name.startswith("m3dssd.")]


def _parent(spans, inner):
    name, s, e, tid = inner
    around = [o for o in spans if o is not inner and o[3] == tid
              and o[1] <= s and e <= o[2]]
    return min(around, key=lambda o: o[2] - o[1])[0] if around else None


def _sync_counts():
    return Counter({k: v for k, v in profiling.counts.items()
                    if k.startswith("sync.")})


def test_span_is_off_without_a_recording_profiler(detectors):
    """No profiler, or one still warming up: `span` gives the shared no-op
    and the trace holds no program span, while the counts still count."""
    assert profiling.span("m3dssd.a") is profiling.span("m3dssd.b")
    assert not isinstance(profiling.span("m3dssd.a"),
                          torch.profiler.record_function)
    det = detectors["base"]
    images, sfs = _images()
    before = _sync_counts()
    det(images, sfs)
    assert _sync_counts() - before == Counter()
    names = set()
    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: names.update(
                     e.name for e in p.events())) as prof:
        det(images, sfs)                                     # warm-up step
        prof.step()
        with torch.profiler.record_function("active_step"):
            pass
        prof.step()
    assert "active_step" in names
    assert not any(n.startswith("m3dssd.") for n in names)


def test_tables_identical_with_profiler_on_and_off(detectors):
    images, sfs = _images()
    for det in detectors.values():
        off = det(images, sfs)
        with profile(activities=[ProfilerActivity.CPU]):
            on = det(images, sfs)
        assert torch.equal(on, off)


@pytest.mark.parametrize("kind", ["fullalign", "base"])
def test_span_names_and_nesting(detectors, kind):
    det = detectors[kind]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        det(*_images())
    spans = _spans(prof)
    names = Counter(n for n, *_ in spans)
    want = {"m3dssd.detect", "m3dssd.backbone", "m3dssd.head",
            "m3dssd.decode_nms", "m3dssd.decode", "m3dssd.nms",
            "m3dssd.nms.round", "m3dssd.table"}
    if kind == "fullalign":
        want |= {"m3dssd.align.select", "m3dssd.align.shape",
                 "m3dssd.align.center2d", "m3dssd.align.center3d",
                 "m3dssd.sync.align.shape", "m3dssd.sync.align.center2d",
                 "m3dssd.sync.align.center3d", "m3dssd.anab",
                 "m3dssd.compact", "m3dssd.sync.decode.sparse",
                 "m3dssd.sync.nms.fixpoint"}
    else:
        # the dense first-k NMS, the plain version on the CPU: one round
        # per table row
        assert names["m3dssd.nms.round"] == 40
    assert set(names) == want
    assert names["m3dssd.detect"] == 1
    for span in spans:
        assert _parent(spans, span) == PARENTS.get(span[0]), span[0]


@pytest.mark.parametrize("kind", ["fullalign", "base"])
def test_sync_counts_match_the_read_backs(detectors, kind, monkeypatch):
    """One `sync.<site>` a read-back of a `cond` or fixpoint that ran, each
    in its span; the dense path has none on the CPU."""
    sites = []
    real = control.read_back

    def spy(site, t):
        sites.append(site)
        return real(site, t)

    monkeypatch.setattr(control, "read_back", spy)
    before = _sync_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        detectors[kind](*_images())
    got = _sync_counts() - before
    want = Counter("sync." + s for s in sites)
    if kind == "fullalign":
        assert {"align.shape", "align.center2d", "align.center3d",
                "decode.sparse", "nms.fixpoint"} == set(sites)
        assert Counter(sites)["align.shape"] == 1
    else:
        assert sites == []
    assert got == want
    spans = Counter(n[len("m3dssd."):] for n, *_ in _spans(prof)
                    if n.startswith("m3dssd.sync."))
    assert spans == got


def test_forced_overflow_counts_the_dense_fallback(detectors):
    """An align budget of one position an image overflows: each align
    module takes its dense branch, counted and spanned, with the tables of
    the sparse path."""
    det = _detector(_conf("fullalign", sparse_align_topm=1))
    images, sfs = _images()
    before = Counter(profiling.counts)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = det(images, sfs)
    delta = Counter(profiling.counts) - before
    sites = ("align.shape", "align.center2d", "align.center3d")
    assert {k: v for k, v in delta.items() if k.startswith("fallback.")} \
        == {"fallback." + s: 1 for s in sites}
    spans = _spans(prof)
    for s in sites:
        fb = [o for o in spans if o[0] == "m3dssd.fallback." + s]
        assert len(fb) == 1 and _parent(spans, fb[0]) == "m3dssd." + s
    assert torch.equal(got, detectors["fullalign"](images, sfs))


def test_export_under_a_profiler_holds_no_profiler_op():
    conf = flagship_conf((64, 128), num_scales=2, backbone="dla34",
                         dtype="float32")
    model = build(conf, device="cpu", seed=0)
    rois = locate_anchors(conf.anchors, conf.feat_size, conf.feat_stride)
    with profile(activities=[ProfilerActivity.CPU]):
        ep = export_detector(conf, rois, model, batch_size=1, device="cpu")
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert sum("cond" in t for t in targets) == 3
    assert not [t for t in targets if "profiler" in t or "record" in t]


@pytest.mark.cuda
@pytest.mark.parametrize("regime", ["dense", "sparse"])
def test_every_sync_of_a_card_detect_is_counted(regime):
    """Under the sync debug mode every sync inside a bs=8 flagship detect
    on the card warns once; the warnings equal the call's `sync.*` counts
    but the pacing's one wait on an event, `sync.detect.inflight`, which
    the debug mode does not flag. No sync of the NMS. A fresh model is
    confident everywhere (align's dense fallback); one biased to the
    background takes the sparse align."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    conf = flagship_conf((384, 1280))
    model = build(conf, seed=0)
    if regime == "sparse":
        bias_background(model, conf.num_classes, 4.0)
    rois = locate_anchors(conf.anchors, conf.feat_size, conf.feat_stride)
    det = make_batch_detector(conf, rois, model)
    gen = torch.Generator(device="cuda").manual_seed(2)
    images = torch.randn((8, 384, 1280, 3), generator=gen, device="cuda")
    sfs = torch.ones(8, device="cuda")
    det(images, sfs)                          # builds and warms the kernels
    torch.cuda.synchronize()
    before = _sync_counts()
    fallbacks = profiling.counts["fallback.align.shape"]
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            det(images, sfs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    synced = [w for w in caught if "synchroniz" in str(w.message)]
    got = _sync_counts() - before
    assert got["sync.detect.inflight"] == 1
    assert not [k for k in got if k.startswith("sync.nms.")]
    assert sum(got.values()) - 1 == len(synced), (got, [
        str(w.message) for w in synced])
    dense = profiling.counts["fallback.align.shape"] - fallbacks
    assert dense == (1 if regime == "dense" else 0)
