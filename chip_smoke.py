"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written kernels from `m3dssd_tpu_torch/csrc/` (one nvcc per
source, in parallel), holds each against its plain PyTorch version at the
shapes the flagship gives it (the shift-DCN forward, and its three backward
kernels at the shapes of a train step), drives the flagship detector
(kitti_3d_anab_fullalign on DLA-102, bf16, seeded random weights) through
`build` and `make_batch_detector` at full width, compares a card run of the
whole detector with a CPU run of the same weights, runs the KITTI eval path
(`test_kitti_3d` over an in-memory synthetic split, result txts and AP),
trains the flagship at 384x1280 bs=8 bf16 (`build(phase="train")`,
`TrainLoader`, `make_train_step`), compares one train step on the card
with a float64 step on the CPU, and that step's DCN backward calls with
the float64 plain backward on the same operands, holds the device target
assignment against the host targets on the same loader batches and trains
with it, and drives a run directory's lifecycle: the train CLI's function
(one Trainer epoch with snapshot, seed and eval), the test CLI's function
from the run's source snapshot in a fresh process, the export CLI's
function and `load_detector`, exported artifacts against eager detect in
both align regimes, and a checkpoint in the original model's layout
imported back under the pinned gather DCN. Every kernel's launch count is
set to 0 before a main-path run and read after it; each phase prints its
seconds. Any failed check ends the run
with a non-zero exit code.

The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}};
the line before it lists each kernel's launches, error and times. Without a
card, or without the port beside this file, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# published peaks of one H100 SXM (dense): bf16 tensor cores, float32 on the
# CUDA cores, and HBM3 bandwidth
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12

# (H, W, Cin, Cout) of the 8 shift-DCN layers of DLASeg(dla102) at 384x1280,
# in the order the neck runs them
NECK_SHAPES_384 = [(12, 40, 1024, 512), (24, 80, 512, 512),
                   (24, 80, 512, 256), (24, 80, 512, 256),
                   (48, 160, 256, 256), (24, 80, 512, 256),
                   (48, 160, 256, 256), (48, 160, 256, 256)]
# (H, W, Cin, Cout, layers of that shape) of the same 8 layers at 512x1760
NECK_SHAPES_512 = [(16, 55, 1024, 512, 1), (32, 110, 512, 512, 1),
                   (32, 110, 512, 256, 3), (64, 220, 256, 256, 3)]
# ragged pixel tile and channel chunks, at clamp 1 (3x3 shifts) and at
# clamp 1.5 (the R = 2 form)
ODD_SHAPE = (2, 5, 11, 40, 72)
ODD_CLAMPS = (1.0, 1.5)
# (B, H, W, Cin, Cout), clamp: H and W no multiple of the bf16 kernel's
# 8x16 pixel tile; Cin = 200 ends in a partial 64-channel chunk. Both give
# too few blocks for the card, so the bf16 kernel splits their reduction
# (as it does for the 384x1280 forward's 12x40 1024->512 layer).
RAGGED_CASES = (((1, 13, 41, 64, 72), 1.0), ((1, 13, 41, 200, 72), 1.5))

# kernel vs plain: float32 differs by summation order; bfloat16 by where
# each rounds to bf16 (the plain version after each shifted MAC, the
# kernel once per 4-corner column), measured against outputs of unit scale
TOL = {torch.float32: 1e-3, torch.bfloat16: 6e-2}
# the kernel each dtype selects
KERNEL_OF = {torch.float32: "f32 CUDA-core",
             torch.bfloat16: "bf16 tensor-core (wgmma)"}
# card (kernel, float32, TF32 off) against the CPU (plain ops, float64),
# relative to the largest magnitude of each output: a float32 run of the
# random-weight DLA-102 detector already differs from float64 by ~2e-3
CARD_CPU_TOL = 1e-2
# share of anchors whose predicted class agrees between card and CPU
CLS_AGREE = 0.999


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg=""):
    print(msg, flush=True)


def card_label():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0].strip()


def ptxas_summary(report):
    """One line per kernel from nvcc's -Xptxas -v report: registers,
    spills and stack; warnings and errors verbatim."""
    out, name = {}, None
    kernel = re.compile(r"Compiling entry function '\S*?(dcn_shift_\w*?"
                        r"_kernel)([^']*)'")
    for line in report.splitlines():
        m = kernel.search(line)
        if m:
            tail = m.group(2)
            r = re.search(r"Li(\d)E", tail)
            dt = "bf16" if "bfloat16" in tail else \
                "f32" if tail.startswith("If") else None
            args = ([dt] if dt and "bwd" in m.group(1) else []) \
                + ([f"R={r.group(1)}"] if r else [])
            name = m.group(1) + (f"<{','.join(args)}>" if args else "")
            out[name] = []
        elif name and ("spill" in line or "registers" in line):
            out[name].append(line.split(":", 1)[-1].strip())
        if "warning" in line or "error" in line:
            out.setdefault("nvcc", []).append(line.strip())
    return [f"{k}: {'; '.join(v)}" for k, v in out.items()]


def count_sass(lib, opcode):
    """Count of `opcode` in the library's SASS, or None without cuobjdump."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = shutil.which("cuobjdump") or os.path.join(CUDA_HOME or "", "bin",
                                                     "cuobjdump")
    if not os.path.exists(tool):
        return None
    res = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                         timeout=120, check=True)
    return sum(opcode in line for line in res.stdout.splitlines())


def cuda_ms(fn, iters, warmup=3):
    """Mean time of fn() in ms by CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def shift_dcn_bound(B, H, W, C, Cout, dtype, K=3):
    """(ms the bytes need, ms the operations need) for one shift-DCN call:
    each input read once and the output written once, against the product
    (2 per MAC) plus a 4-corner bilinear sample (8 per sampled element),
    at the card's peak for dtype."""
    es = torch.finfo(dtype).bits // 8
    KK = K * K
    P = B * H * W
    nbytes = (P * C * es + P * KK * 2 * 4 + P * KK * 4 + KK * C * Cout * es
              + Cout * 4 + P * Cout * es)
    flops = 2.0 * P * KK * C * Cout + 8.0 * P * KK * C
    return nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS[dtype] * 1e3


def shift_dcn_inputs(B, H, W, C, Cout, dtype, device, seed, clamp=1.0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(B, H, W, C, generator=g)
    off = torch.randn(B, H, W, 9, 2, generator=g) * 1.2 * clamp  # +-clamp
    mask = torch.rand(B, H, W, 9, generator=g)
    w = torch.randn(3, 3, C, Cout, generator=g) / math.sqrt(9 * C)
    b = torch.randn(Cout, generator=g) * 0.1
    return (x.to(device, dtype), off.to(device), mask.to(device),
            w.to(device, dtype), b.to(device))


def phase_kernel_vs_plain(device):
    """The shift-DCN kernels against their plain version at the neck shapes
    of one 384x1280 image, of a 384x1280 batch of 8 (the eval run's) and of
    a 512x1760 batch of 8, and at odd and ragged shapes, in float32
    (CUDA-core kernel) and bfloat16 (tensor-core kernel). Returns the bf16
    sums over each of the three forwards' 8 layers:
    {run: {ms, plain_ms, bound_ms, bytes_ms, ops_ms}}, and the largest
    bf16 max|diff|."""
    from m3dssd_tpu_torch.ops import dcn as tdcn
    from m3dssd_tpu_torch.ops import dcn_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sms = dcn_cuda.num_sms(device)
    # (forward it belongs to, (B, H, W, Cin, Cout), clamp, layers it stands for)
    cases = ([("384x1280 bs=1", (1,) + s, 1.0, 1) for s in NECK_SHAPES_384]
             + [("384x1280 bs=8", (8,) + s, 1.0, 1) for s in NECK_SHAPES_384]
             + [("512x1760 bs=8", (8,) + s[:4], 1.0, s[4])
                for s in NECK_SHAPES_512]
             + [("odd", ODD_SHAPE, c, 0) for c in ODD_CLAMPS]
             + [("ragged", s, c, 0) for s, c in RAGGED_CASES])
    totals = {run: dict.fromkeys(("ms", "plain_ms", "bound_ms", "bytes_ms",
                                  "ops_ms"), 0.0)
              for run, _, _, n in cases if n}
    max_err = 0.0
    log("shift-DCN kernel vs plain (B,H,W,Cin->Cout clamp dtype [kernel, "
        "bf16 split S]: max|diff| kernel_ms plain_ms bound_ms bound_by "
        "share_of_bound)")
    for dtype in (torch.float32, torch.bfloat16):
        log(f" {KERNEL_OF[dtype]} kernel:")
        for i, (run, (B, H, W, C, Co), clamp, n) in enumerate(cases):
            args = shift_dcn_inputs(B, H, W, C, Co, dtype, device, seed=i,
                                    clamp=clamp)
            kernel = lambda: dcn_cuda.dcn_v2_shift_cuda(*args, clamp=clamp)
            plain = lambda: tdcn.dcn_v2_shift_reference(*args, clamp=clamp)
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            scale = float(want.float().abs().max())
            check(math.isfinite(err) and err <= TOL[dtype] * max(1.0, scale),
                  f"kernel disagrees with plain at {(B, H, W, C, Co)} clamp "
                  f"{clamp} {dtype}: max|diff| {err} (scale {scale})")
            del got, want
            size = B * H * W * C * Co
            iters = 50 if size < 1e8 else 20 if size < 1e9 else 5
            k_ms = cuda_ms(kernel, max(iters, 20))
            p_ms = cuda_ms(plain, iters)
            t_bytes, t_ops = shift_dcn_bound(B, H, W, C, Co, dtype)
            bound = max(t_bytes, t_ops)
            by = "bytes" if t_bytes > t_ops else "operations"
            name = str(dtype).replace("torch.", "")
            split = ""
            if dtype == torch.bfloat16:
                S = dcn_cuda.plan(B, H, W, C, Co, math.ceil(clamp), sms).split
                split = f", split {S}"
            log(f"  {B},{H},{W},{C}->{Co} {clamp} {name} [{KERNEL_OF[dtype]}"
                f"{split}]: {err:.3e} {k_ms:.4f} {p_ms:.4f} {bound:.4f} {by} "
                f"{bound / k_ms:.4f}")
            if dtype == torch.bfloat16:
                max_err = max(max_err, err)
                if n:
                    t = totals[run]
                    for key, v in (("ms", k_ms), ("plain_ms", p_ms),
                                   ("bound_ms", bound), ("bytes_ms", t_bytes),
                                   ("ops_ms", t_ops)):
                        t[key] += n * v
            del args
    for run, t in totals.items():
        log(f"  one {run} forward's 8 neck layers, bf16: kernel "
            f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms, share of bound "
            f"{t['bound_ms'] / t['ms']:.4f}")
    log("  no single PyTorch call computes this function (library_ms null)")
    torch.cuda.empty_cache()
    return totals, max_err


def perturb_neck_offsets(model, seed):
    """Small random offset/mask convs for every neck DCN (zero at init), so
    the kernel sees fractional offsets, some past +-1. Drawn on the CPU, so
    a seed gives the same values on every device."""
    from m3dssd_tpu_torch.models.necks import DCN

    g = torch.Generator(device="cpu").manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, DCN):
                w = m.conv_offset_mask.weight
                fan_in = w[0].numel()
                w.copy_(torch.randn(w.shape, generator=g)
                        * (3.0 / math.sqrt(fan_in)))
                b = m.conv_offset_mask.bias
                b.copy_(torch.randn(b.shape, generator=g) * 0.3)
    return model


def packed_images(B, H, W, seed, device):
    from m3dssd_tpu_torch.models.dla import space_to_depth

    g = torch.Generator(device="cpu").manual_seed(seed)
    return space_to_depth(torch.randn(B, H, W, 3, generator=g)).to(device)


# (input size, batch, background bias, timed calls) of the detect runs
DETECT_RUNS = (((512, 1760), 8, None, 5), ((512, 1760), 8, 4.0, 5),
               ((384, 1280), 1, None, 20))
# input size of the card-against-CPU run
CARD_CPU_CROP = (128, 448)


def phase_detect(label):
    """The flagship detector, bf16, through the user's entry points; the
    kernel's launch count is set to 0 before each run's first call and
    read after it. Returns the launches summed over the runs."""
    from m3dssd_tpu_torch.anchors import locate_anchors
    from m3dssd_tpu_torch.config import flagship_conf
    from m3dssd_tpu_torch.inference.detect import make_batch_detector
    from m3dssd_tpu_torch.models import bias_background, build
    from m3dssd_tpu_torch.ops import dcn_cuda

    launches = 0
    for crop, B, bg, iters in DETECT_RUNS:
        conf = flagship_conf(crop)
        t0 = time.perf_counter()
        model = perturb_neck_offsets(build(conf, seed=0), seed=1)
        if bg is not None:
            bias_background(model, conf.num_classes, bg)
        rois = locate_anchors(conf.anchors, conf.feat_size, conf.feat_stride)
        detect = make_batch_detector(conf, rois, model, packed_input=True)
        images = packed_images(B, crop[0], crop[1], seed=2, device="cuda")
        sfs = torch.ones(B, device="cuda")
        setup_s = time.perf_counter() - t0

        dcn_cuda.launches = 0
        dets = detect(images, sfs).cpu()
        n = dcn_cuda.launches
        check(n == 8, f"{crop} bs={B}: shift-DCN kernel launched {n} "
              "times in one forward, expected 8")
        launches += n
        check(tuple(dets.shape) == (B, conf.nms_topN_post, 14),
              f"dets shape {tuple(dets.shape)}")
        check(bool(torch.isfinite(dets).all()), "non-finite dets")
        valid = (dets[..., 4] > 0).sum(dim=1).tolist()

        ms = cuda_ms(lambda: detect(images, sfs), iters, warmup=2)
        tag = f"{crop[0]}x{crop[1]} bs={B}" + ("" if bg is None else
                                                f" bias_background({bg})")
        log(f"detect {tag}: dets {tuple(dets.shape)} finite, valid per "
            f"image {valid}; {ms:.2f} ms per call = {B * 1e3 / ms:.1f} "
            f"im/s ({label}); set-up {setup_s:.1f} s")
        del model, detect, images
        torch.cuda.empty_cache()
    return launches


def _rel_err(got, ref):
    ref = ref.double()
    return float((got.double() - ref).abs().max()
                 / ref.abs().max().clamp(min=1e-12))


def _rel_quantile(got, ref, q):
    """The q quantile of |got - ref| over ref's largest magnitude."""
    ref = ref.double()
    d = (got.double() - ref).abs().flatten() / ref.abs().max().clamp(
        min=1e-12)
    return float(d.max()) if q == 1.0 else float(torch.quantile(d, q))


def phase_card_vs_cpu():
    """The full-width flagship at 128x448 on the card through the kernel
    (float32, TF32 off) against the same weights on the CPU through the
    plain ops, in float64 (the truth) and in float32 (the rounding noise
    of a float32 run of this random-weight network)."""
    from m3dssd_tpu_torch.anchors import locate_anchors
    from m3dssd_tpu_torch.config import flagship_conf
    from m3dssd_tpu_torch.inference.detect import (_Decoder,
                                                   make_batch_detector)
    from m3dssd_tpu_torch.models import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    crop = CARD_CPU_CROP
    conf = flagship_conf(crop, dtype="float32").replace(nms_score_stop=False)
    rois = locate_anchors(conf.anchors, conf.feat_size, conf.feat_stride)
    images = packed_images(1, crop[0], crop[1], seed=3, device="cpu")
    sfs = torch.ones(1)
    card, cpu = "cuda", "cpu"
    runs = {"card": (card, torch.float32), "cpu32": (cpu, torch.float32),
            "cpu64": (cpu, torch.float64)}
    outs, dets = {}, {}
    for name, (dev, dtype) in runs.items():
        model = perturb_neck_offsets(build(conf, device=dev, seed=0), seed=1)
        model = model.to(dtype)
        with torch.inference_mode():
            outs[name] = {k: v.cpu() if isinstance(v, torch.Tensor) else v
                          for k, v in model(images.to(dev, dtype),
                                            packed=True).items()}
        if name != "cpu64":
            dets[name] = make_batch_detector(
                conf, rois, model, packed_input=True, device=dev)(
                    images, sfs).cpu()

    worst = {"card": 0.0, "cpu32": 0.0}
    for k, ref in outs["cpu64"].items():
        if not isinstance(ref, torch.Tensor):
            check(outs["card"][k] == ref, f"{k}: {outs['card'][k]} vs {ref}")
            continue
        if k == "cls_pred":
            # a class id: the argmax flips where two fg logits nearly tie
            cls_agree = float((outs["card"][k] == ref).float().mean())
            check(cls_agree >= CLS_AGREE,
                  f"cls_pred agrees at {cls_agree} of anchors")
            continue
        for name in worst:
            worst[name] = max(worst[name], _rel_err(outs[name][k], ref))
        err = _rel_err(outs["card"][k], ref)
        check(err <= CARD_CPU_TOL, f"card output {k}: relative max|diff| "
              f"{err} against the float64 CPU run")

    # decode + NMS on the card and on the CPU from the same model outputs
    same = {}
    for dev in (card, cpu):
        dec = _Decoder(conf, rois, torch.device(dev))
        o = {k: v.to(dev) for k, v in outs["cpu32"].items()
             if isinstance(v, torch.Tensor)}
        same[dev] = dec.finish(o["scores"], o["cls_pred"], dec.rois_t,
                               dec.src3d_t, o["bbox_2d"], o["bbox_3d"],
                               sfs.to(dev)).cpu()
    check(torch.equal(same[card][..., 13], same[cpu][..., 13]),
          "decode+NMS picks other survivors on the card")
    check(torch.allclose(same[card], same[cpu], rtol=1e-5, atol=1e-4),
          "decode+NMS values differ on the card")
    # whole-run dets: the survivors follow scores that differ by float32
    # noise, so rows are matched by box, not by slot
    check(dets["card"].shape == dets["cpu32"].shape
          and bool(torch.isfinite(dets["card"]).all()), "card dets")
    d2 = (dets["card"][0, :, None, :4] - dets["cpu32"][0, None, :, :4])
    rows = int(((d2.abs().amax(-1) <= 1e-2 * dets["cpu32"][0, :, :4]
                 .abs().max()).any(-1)).sum())
    log(f"card vs CPU at {crop[0]}x{crop[1]}: largest relative output diff "
        f"against float64 {worst['card']:.3e} for the card in float32 "
        f"(limit {CARD_CPU_TOL}), {worst['cpu32']:.3e} for the CPU in "
        f"float32; cls_pred agrees at {cls_agree:.6f} of anchors; "
        "decode+NMS identical on the same outputs; "
        f"{rows}/{dets['card'].shape[1]} card dets have a box within 1% "
        "among the float32 CPU run's dets")
    return worst


# the eval phase: an in-memory synthetic split of KITTI-sized images
# through the batched test driver at the flagship's test scale
EVAL_CROP = (384, 1280)
EVAL_IMAGES = 64
EVAL_BATCH = 8
EVAL_IM = (375, 1242)
# bisection steps on the Car bias that sets the detections per image
EVAL_BISECT_STEPS = 7
# the sparse pre-NMS budget (anchors) of the bs=1 comparison
SPARSE_TOPM = 8192


def confident_cars(model, conf, batches, detect, target):
    """Turn the random-weight detector into one that, like a trained one,
    finds the background almost everywhere and a car about where the
    split has one: raise the background logit (`bias_background`), widen
    the Car logit's spread across anchors to about 1 (at init it is nearly
    constant), and bisect one Car bias until `detect` keeps about `target`
    detections per image at or above conf.score_thres over `batches` (the
    split's gt objects per image). Returns (Car bias, detections per
    image at it)."""
    from m3dssd_tpu_torch.models import bias_background

    C = conf.num_classes
    conv = model.cls_tower.Conv_2
    bias_background(model, C, 4.0)

    def car_logits(images):
        with torch.inference_mode():
            cls = model(images, packed=True)["cls"].float()    # [B, N, C]
        others = torch.cat([cls[..., :1], cls[..., 2:]], -1)
        return cls[..., 1], cls[..., 1] - torch.logsumexp(others, -1)

    car, _ = car_logits(batches[0])
    with torch.no_grad():
        conv.weight[1::C] *= 1.0 / float(car.std())
    _, margin = car_logits(batches[0])
    margin = margin.flatten().cpu()
    t = conf.score_thres
    N = margin.numel() // batches[0].shape[0]

    def bias_for(k):    # about k anchors per image score at least t
        return math.log(t / (1.0 - t)) - float(
            torch.quantile(margin, 1.0 - k / N))

    base = conv.bias[1::C].clone()
    sfs = torch.ones(batches[0].shape[0], device=batches[0].device)

    def per_image(bias):
        with torch.no_grad():
            conv.bias[1::C] = base + bias
        kept = sum(int((detect(imb, sfs)[..., 4] >= t).sum())
                   for imb in batches)
        return kept / sum(imb.shape[0] for imb in batches)

    lo, hi = bias_for(0.25), bias_for(100.0)
    for _ in range(EVAL_BISECT_STEPS):
        mid = 0.5 * (lo + hi)
        if per_image(mid) < target:
            lo = mid
        else:
            hi = mid
    return hi, per_image(hi)


def eval_setup(device):
    """The eval run's inputs: the flagship (bf16, seeded random weights,
    perturbed neck offsets) at EVAL_CROP, an in-memory synthetic split of
    EVAL_IMAGES images of EVAL_IM, its batches packed and on the card, and
    a packed-input batch detector tuned by `confident_cars` to keep as
    many detections per image as the split has gt objects."""
    from types import SimpleNamespace

    from m3dssd_tpu_torch.anchors import locate_anchors
    from m3dssd_tpu_torch.config import flagship_conf
    from m3dssd_tpu_torch.data.synthetic import SyntheticEvalSet
    from m3dssd_tpu_torch.inference import test_driver as drv
    from m3dssd_tpu_torch.inference.detect import make_batch_detector
    from m3dssd_tpu_torch.models import build

    device = torch.device(device)
    B, n = EVAL_BATCH, EVAL_IMAGES
    conf = flagship_conf(EVAL_CROP)
    data = SyntheticEvalSet(conf, n, seed=5, imW=EVAL_IM[1], imH=EVAL_IM[0])
    gt_per_image = sum(len(data.labels(i)) for i in range(n)) / n
    model = perturb_neck_offsets(build(conf, device=device, seed=0), seed=1)
    rois = locate_anchors(conf.anchors, conf.feat_size, conf.feat_stride)
    pack = drv._packer(conf, packed_input=True, pin=device.type == "cuda")
    batches = [torch.cat([pack(data[i]["input"]) for i in range(s, s + B)])
               .to(device) for s in range(0, n, B)]
    detect = make_batch_detector(conf, rois, model, packed_input=True,
                                 device=device)
    car_bias, det_per_image = confident_cars(model, conf, batches, detect,
                                             gt_per_image)
    return SimpleNamespace(
        conf=conf, data=data, model=model, rois=rois, pack=pack,
        batches=batches, sfs=torch.ones(B, device=device), detect=detect,
        device=device, car_bias=car_bias, gt_per_image=gt_per_image,
        det_per_image=det_per_image)


def read_txts(folder):
    return {f: open(os.path.join(folder, f)).read()
            for f in sorted(os.listdir(folder)) if f.endswith(".txt")}


def check_rows(txts, lbls):
    """Every row of every result txt parses into 16 KITTI fields."""
    rows = 0
    for name, text in txts.items():
        for line in text.splitlines():
            f = line.split()
            check(len(f) == 16 and f[0] in lbls,
                  f"{name}: malformed row {line!r}")
            vals = [float(v) for v in f[1:]]
            check(all(math.isfinite(v) for v in vals), f"{name}: {line!r}")
            rows += 1
    return rows


def phase_eval(label, device="cuda"):
    """The eval path: `test_kitti_3d` over an in-memory synthetic split at
    384x1280 bs=8 (bf16, packed input), result txts and AP; then the
    driver's loop again, its parts timed on the same batches, both AP
    engines on the gt written as detections, and the sparse pre-NMS path
    at bs=1. Returns the kernel's launches in the driver's run.
    `profile_eval.py` times other forms of the loop."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from m3dssd_tpu_torch.eval import devkit, kitti_eval, native
    from m3dssd_tpu_torch.inference import test_driver as drv
    from m3dssd_tpu_torch.inference.detect import (_compact_positions,
                                                   _sparse_nms_cfg,
                                                   make_batch_detector)
    from m3dssd_tpu_torch.ops import dcn_cuda

    B, n = EVAL_BATCH, EVAL_IMAGES
    t0 = time.perf_counter()
    ev = eval_setup(device)
    conf, data, detect, sfs = ev.conf, ev.data, ev.detect, ev.sfs
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        gt = data.write_labels(os.path.join(tmp, "gt"))
        results = os.path.join(tmp, "results")
        dcn_cuda.launches = 0
        t0 = time.perf_counter()
        res, sel = drv.test_kitti_3d(data, detect, conf, results, gt_path=gt,
                                     batch_size=B, packed_input=True)
        entry_s = time.perf_counter() - t0
        launches = dcn_cuda.launches
        nb = -(-n // B)
        check(launches == 8 * nb, f"eval: shift-DCN kernel launched "
              f"{launches} times in {nb} batches, expected 8 per batch")
        txts = read_txts(results)
        check(sorted(txts) == [f"{i:06d}.txt" for i in range(n)],
              f"eval: {len(txts)} result txts for {n} images")
        rows = check_rows(txts, conf.lbls)
        check(rows > 0, "eval: no result rows")
        check("Car_3d_R40" in res and len(res["Car_3d_R40"]) == 3
              and all(math.isfinite(v) for v in res["Car_3d_R40"]),
              f"eval: AP dict {sorted(res)}")

        # the loop's parts on the same batches: detect alone, then the
        # host post-process alone
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dets = [detect(imb, sfs) for imb in ev.batches]
        torch.cuda.synchronize()
        detect_s = time.perf_counter() - t0
        arrs = [d.cpu().numpy() for d in dets]
        t0 = time.perf_counter()
        post = [drv.postprocess_dets(conf, arr[j], data.p2,
                                     np.linalg.inv(data.p2))
                for arr in arrs for j in range(B)]
        post_s = time.perf_counter() - t0
        flat = conf.replace(hill_climbing=False)
        climbed = 0
        for k, arr in enumerate(arrs):
            for j in range(B):
                plain = drv.postprocess_dets(flat, arr[j], data.p2,
                                             np.linalg.inv(data.p2))
                climbed += sum(
                    (a["z3d"], a["ry3d"]) != (b["z3d"], b["ry3d"])
                    for a, b in zip(post[k * B + j], plain))
        check(climbed > 0, "eval: no row moved under hill climbing")

        # the prefetch alone: read and pack every image on the driver's
        # 8 threads
        with ThreadPoolExecutor(max_workers=8) as pool:
            t0 = time.perf_counter()
            packed = list(pool.map(lambda i: ev.pack(data[i]["input"]),
                                   range(n)))
            prefetch_s = time.perf_counter() - t0
        del packed

        # the driver's loop twice more, warm; every run writes the same
        # bytes
        loop_s = []
        for i in range(2):
            d = os.path.join(tmp, f"loop{i}")
            os.makedirs(d)
            t0 = time.perf_counter()
            drv._run_batched(data, detect, conf, d, B, ev.pack, ev.device)
            loop_s.append(time.perf_counter() - t0)
            check(read_txts(d) == txts, "eval: a second run of the loop "
                  "wrote other bytes")

        # AP: the pass over the results, and the gt as detections (100 on
        # every Car metric) on each engine this machine has
        engines = ["native", "python"] if native.available() else ["python"]
        dt = os.path.join(tmp, "gt_as_dt")
        os.makedirs(dt)
        k = 0
        for name, text in read_txts(gt).items():
            lines = []
            for line in filter(None, text.splitlines()):
                k += 1          # distinct scores: one recall step per row
                lines.append(f"{line} {1.0 - k * 1e-4:.4f}\n")
            with open(os.path.join(dt, name), "w") as f:
                f.write("".join(lines))
        ap_s = {}
        has_native = native.available
        try:
            for engine in engines:
                # the Python engine runs where the native one is off
                native.available = has_native if engine == "native" \
                    else (lambda: False)
                t0 = time.perf_counter()
                kitti_eval.evaluate_kitti(gt, results, classes=conf.lbls)
                ap_s[engine] = time.perf_counter() - t0
                got = kitti_eval.evaluate_kitti(gt, dt, classes=["Car"])
                bad = {k: v for k, v in got.items() if k != "_text"
                       and any(abs(x - 100.0) > 1e-9 for x in v)}
                check(not bad, f"eval: {engine} engine on the gt as "
                      f"detections: {bad}")
        finally:
            native.available = has_native
        # the devkit-protocol oracle, written apart from both engines
        oracle = devkit.evaluate(gt, dt) if devkit.available() else None
        if oracle is not None:
            bad = {k: v for k, v in oracle.items() if k.startswith("Car_")
                   and any(abs(x - 100.0) > 1e-6 for x in v)}
            check("Car_box3d_R40" in oracle and not bad,
                  f"eval: devkit oracle on the gt as detections: {bad}")

    # the sparse pre-NMS path at bs=1 against the dense path, on the first
    # batch's image with the most detections
    conf_sp = conf.replace(nms_sparse_topm=SPARSE_TOPM)
    m_pos, A, thresh = _sparse_nms_cfg(conf_sp, ev.rois)
    j = int((arrs[0][..., 4] >= thresh).sum(-1).argmax())
    img, sf1 = ev.batches[0][j:j + 1], torch.ones(1, device=ev.device)
    det1 = make_batch_detector(conf, ev.rois, ev.model, packed_input=True,
                               device=ev.device)
    det_sp = make_batch_detector(conf_sp, ev.rois, ev.model,
                                 packed_input=True, device=ev.device)
    with torch.inference_mode():
        scores = ev.model(img, packed=True)["scores"].float()
    posmax = scores.reshape(1, -1, A).amax(-1)
    n_pos = int((posmax >= thresh).sum())
    check(bool(_compact_positions(scores, A, thresh, m_pos)[1].all()),
          f"sparse bs=1: {n_pos} confident positions overflow {m_pos}")
    a, b = det1(img, sf1).cpu(), det_sp(img, sf1).cpu()
    keep_a, keep_b = a[0][a[0, :, 4] >= thresh], b[0][b[0, :, 4] >= thresh]
    check(keep_a.shape == keep_b.shape and keep_a.shape[0] > 0
          and torch.equal(keep_a[:, 13], keep_b[:, 13])
          and torch.allclose(keep_a, keep_b, rtol=1e-5, atol=1e-4),
          "sparse bs=1: kept rows differ from the dense path")
    sp_ms = {"dense": [], "sparse": []}
    for kind in ("dense", "sparse", "sparse", "dense"):
        det = det1 if kind == "dense" else det_sp
        sp_ms[kind].append(cuda_ms(lambda: det(img, sf1), 10, warmup=2))

    ips = lambda s: n / s
    log(f"eval {EVAL_CROP[0]}x{EVAL_CROP[1]} bs={B}, {n} synthetic "
        f"{EVAL_IM[0]}x{EVAL_IM[1]} images ({ev.gt_per_image:.3f} gt "
        f"objects per image), packed bf16, background logit +4, Car logit "
        f"{ev.car_bias:+.4f} for {ev.det_per_image:.3f} detections per "
        f"image ({label}); set-up {setup_s:.1f} s")
    log(f"  test_kitti_3d with AP: {entry_s:.3f} s, {rows} rows in {n} "
        f"txts ({rows / n:.3f} per image), {climbed} rows moved by hill "
        f"climbing; Car_3d_R40 {res['Car_3d_R40']}; launches {launches} "
        f"({launches // nb} per batch)")
    log(f"  whole loop (prefetch, upload, detect, post-process, write), "
        f"warm: {', '.join(f'{ips(s):.2f}' for s in loop_s)} im/s "
        f"({loop_s} s); every run wrote the same bytes")
    log(f"  prefetch only (read and pack on 8 threads): "
        f"{ips(prefetch_s):.2f} im/s")
    log(f"  detect only on the same batches: {ips(detect_s):.2f} im/s "
        f"({detect_s * 1e3 / nb:.2f} ms per batch)")
    log(f"  host post-process (hill climbing on): "
        f"{post_s * 1e3 / n:.3f} ms per image")
    log(f"  AP pass over {n} images: " + ", ".join(
        f"{e} {ap_s[e]:.3f} s" for e in engines) + "; engines that ran: "
        + ", ".join(engines) + " (gt as detections: 100.0 on every Car "
        "metric on each); devkit oracle: " + (
            "100.0 on every Car metric" if oracle is not None
            else "not built (no g++)"))
    log(f"  sparse pre-NMS at bs=1 ({n_pos} confident positions, budget "
        f"{m_pos}, {keep_a.shape[0]} kept rows): dense {sp_ms['dense']} ms, "
        f"sparse {sp_ms['sparse']} ms per call; kept rows identical")
    return launches


# --------------------------------------------------------------------------
# the shift-DCN backward kernels (csrc/dcn_shift_bwd.cu)
# --------------------------------------------------------------------------

# kernel vs plain, relative to the largest magnitude of each gradient:
# float32 differs by summation order; bfloat16 also by where the sums
# round to bf16 (the plain columns and dx after every shifted MAC, the
# kernels once per element) and by cuBLAS's rounding of gk
BWD_TOL = {torch.float32: {"dx": 1e-4, "doffset": 1e-4, "dmask": 1e-4,
                           "dweight": 1e-4},
           torch.bfloat16: {"dx": 3e-2, "doffset": 5e-2, "dmask": 5e-2,
                            "dweight": 5e-2}}
# share of offsets drawn exactly on a kink: 0, the knots +-1, +-clamp
TIE_SHARE = 0.3
BWD_KERNELS = ("cols", "data", "coord")
# the limit each kernel's output is held to against its plain version
BWD_KERNEL_TOL = {"cols": "dweight", "data": "dx", "coord": "doffset"}
# (kind, (B, H, W, Cin, Cout), clamp) of the tiling of the cols, data and
# coord kernels (ops/dcn_cuda.py:bwd_plan): tiles partial in H and W over
# two images with a partial channel chunk (data's per-tap gk boxes reach
# into neither the next image nor past the image's edge); every offset
# exactly on +-clamp ("edge": cols' corners R-1, R and data's knots +-R
# stay in their slab or box); C = 20, no whole number of 16-byte bf16
# vectors (the wrappers pad C)
BWD_TILING_CASES = [("tiles", (2, 13, 21, 72, 16), 1.0),
                    ("edge", (1, 9, 17, 40, 8), 1.0),
                    ("edge", (1, 9, 17, 40, 8), 1.5),
                    ("c20", (2, 5, 11, 20, 8), 1.0),
                    ("c20", (2, 5, 11, 20, 8), 1.5)]


def bwd_inputs(B, H, W, C, Cout, dtype, device, seed, clamp, edge=False):
    """Inputs of one backward call: x, offset (TIE_SHARE of them exactly
    on a kink, or with `edge` all of them on +-clamp), mask, weight and the
    output cotangent g."""
    x, off, mask, w, _ = shift_dcn_inputs(B, H, W, C, Cout, dtype, "cpu",
                                          seed, clamp)
    g = torch.Generator(device="cpu").manual_seed(seed + 1000)
    kinks = torch.tensor([0.0, 1.0, -1.0, clamp, -clamp])
    pick = torch.rand(off.shape, generator=g) < TIE_SHARE
    which = torch.randint(0, len(kinks), off.shape, generator=g)
    off = torch.where(pick, kinks[which], off)
    if edge:
        off = torch.where(off >= 0, clamp, -clamp)
    gout = torch.randn(B, H, W, Cout, generator=g).to(dtype)
    return (x.to(device), off.to(device), mask.to(device), w.to(device),
            gout.to(device))


def bwd_bounds(B, H, W, C, Cout, dtype, off, clamp, K=3):
    """{kernel: (ms the bytes need, ms the operations need)} for one call:
    inputs read once, outputs written once; 2 operations per multiply-add
    on the float32 CUDA cores. cols and data skip the knots that carry no
    weight, so their operations are counted from this call's offsets."""
    es = torch.finfo(dtype).bits // 8
    KK, P = K * K, B * H * W
    R = math.ceil(clamp)
    o = off.float().clamp(-clamp, clamp)
    knots = torch.arange(-R, R + 1, device=off.device, dtype=torch.float32)
    nz = (1.0 - (o[..., None] - knots).abs() > 0).sum(-1)    # [B,H,W,KK,2]
    terms = float((nz[..., 0] * nz[..., 1]).sum())
    col = P * KK * C * es
    small = P * KK * 3 * 4                                   # offset, mask
    ops = {"cols": 2.0 * terms * C, "data": 2.0 * terms * C,
           "coord": 2.0 * P * KK * (2 * R + 1) ** 2 * C}
    nbytes = {"cols": P * C * es + small + col,
              "data": col + small + P * C * es,
              "coord": P * C * es + col + small + P * KK * 3 * 4}
    return {k: (nbytes[k] / PEAK_BYTES * 1e3,
                ops[k] / PEAK_FLOPS[torch.float32] * 1e3) for k in ops}


def phase_bwd_vs_plain(device):
    """The three backward kernels and the whole backward against their
    plain versions at the 8 neck shapes of a 384x1280 bs=8 batch and at the
    odd and ragged cases, at clamp 1.0 and 1.5, in float32 and bfloat16.
    Returns the bf16 sums over the 8 neck layers ({kernel: {ms, plain_ms,
    bound_ms, bytes_ms, ops_ms}}, the products' ms) and the largest bf16
    max|kernel - plain| of each kernel's output."""
    from m3dssd_tpu_torch.ops import dcn as tdcn
    from m3dssd_tpu_torch.ops import dcn_cuda as dc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cases = ([("neck", (8,) + s, 1.0) for s in NECK_SHAPES_384]
             + [("odd", ODD_SHAPE, c) for c in ODD_CLAMPS]
             + [("ragged", s, c) for s, c in RAGGED_CASES]
             + [("neck c1.5", (8,) + NECK_SHAPES_384[4], 1.5)]
             + BWD_TILING_CASES)
    keys = ("ms", "plain_ms", "bound_ms", "bytes_ms", "ops_ms")
    totals = {k: dict.fromkeys(keys, 0.0) for k in BWD_KERNELS}
    prod_ms = 0.0
    max_err = dict.fromkeys(BWD_KERNELS, 0.0)
    log("shift-DCN backward kernels vs plain (B,H,W,Cin->Cout clamp dtype: "
        "rel. max|diff| of dx doffset dmask dW; per kernel ms / plain ms / "
        "bound ms / share of bound; products ms)")
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        for i, (kind, (B, H, W, C, Co), clamp) in enumerate(cases):
            x, off, mask, w, g = bwd_inputs(B, H, W, C, Co, dtype, device,
                                            seed=100 + i, clamp=clamp,
                                            edge=kind == "edge")
            got = dc.dcn_v2_shift_backward_cuda(x, off, mask, w, g,
                                                clamp=clamp)
            want = tdcn.dcn_v2_shift_backward_reference(x, off, mask, w, g,
                                                        clamp=clamp)
            torch.cuda.synchronize()
            errs = []
            for gname, a, b in zip(("dx", "doffset", "dmask", "dweight"),
                                   got, want):
                scale = float(b.float().abs().max())
                err = float((a.float() - b.float()).abs().max()) \
                    / max(scale, 1e-12)
                check(math.isfinite(err) and err <= BWD_TOL[dtype][gname],
                      f"backward {gname} disagrees with plain at "
                      f"{(B, H, W, C, Co)} clamp {clamp} {name}: relative "
                      f"max|diff| {err} (scale {scale})")
                errs.append(err)
            del got, want
            g2 = g.reshape(-1, Co)
            w2 = w.reshape(-1, Co)
            gk = torch.matmul(g2, w2.t())
            col = dc.dcn_shift_bwd_cols_cuda(x, off, mask, clamp=clamp)
            big = kind.startswith("neck")
            it_k, it_p = (10, 2) if big else (20, 5)
            runs = {
                "cols": (lambda: dc.dcn_shift_bwd_cols_cuda(
                    x, off, mask, clamp=clamp),
                    lambda: tdcn.shift_columns_reference(
                        x, off, mask, clamp=clamp)),
                "data": (lambda: dc.dcn_shift_bwd_data_cuda(
                    gk, off, mask, x.shape, clamp=clamp),
                    lambda: tdcn.shift_dx_reference(
                        gk, off, mask, x.shape, clamp=clamp)),
                "coord": (lambda: dc.dcn_shift_bwd_coord_cuda(
                    x, gk, off, mask, clamp=clamp),
                    lambda: tdcn.shift_coord_reference(
                        x, gk, off, mask, clamp=clamp)),
            }
            bounds = bwd_bounds(B, H, W, C, Co, dtype, off, clamp)
            parts = []
            for k, (kern, plain) in runs.items():
                ka, pa = kern(), plain()
                ka = ka if isinstance(ka, tuple) else (ka,)
                pa = pa if isinstance(pa, tuple) else (pa,)
                abs_err = max(float((u.float() - v.float()).abs().max())
                              for u, v in zip(ka, pa))
                rel = max(float((u.float() - v.float()).abs().max())
                          / max(float(v.float().abs().max()), 1e-12)
                          for u, v in zip(ka, pa))
                lim = BWD_TOL[dtype][BWD_KERNEL_TOL[k]]
                check(math.isfinite(rel) and rel <= lim,
                      f"{k} kernel disagrees with plain at "
                      f"{(B, H, W, C, Co)} clamp {clamp} {name}: relative "
                      f"max|diff| {rel} (limit {lim})")
                if dtype == torch.bfloat16:
                    max_err[k] = max(max_err[k], abs_err)
                del ka, pa
                k_ms = cuda_ms(kern, it_k, warmup=2)
                p_ms = cuda_ms(plain, it_p, warmup=1)
                t_b, t_o = bounds[k]
                bound = max(t_b, t_o)
                parts.append(f"{k} {k_ms:.4f}/{p_ms:.4f}/{bound:.4f}/"
                             f"{bound / k_ms:.3f}")
                if dtype == torch.bfloat16 and kind == "neck":
                    t = totals[k]
                    for key, v in (("ms", k_ms), ("plain_ms", p_ms),
                                   ("bound_ms", bound), ("bytes_ms", t_b),
                                   ("ops_ms", t_o)):
                        t[key] += v
            m_ms = cuda_ms(lambda: (torch.matmul(g2, w2.t()),
                                    torch.matmul(col.t(), g2)), it_k,
                           warmup=2)
            if dtype == torch.bfloat16 and kind == "neck":
                prod_ms += m_ms
            log(f"  {B},{H},{W},{C}->{Co} {clamp} {name}: "
                + " ".join(f"{e:.2e}" for e in errs) + "; "
                + "; ".join(parts) + f"; products {m_ms:.4f}")
            del x, off, mask, w, g, gk, col
    for k, t in totals.items():
        log(f"  one 384x1280 bs=8 backward's 8 neck layers, bf16, {k}: "
            f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({'bytes' if t['bytes_ms'] > t['ops_ms'] else 'operations'}), "
            f"share of bound {t['bound_ms'] / t['ms']:.4f}")
    log(f"  the products gk = g W^T and dW = col^T g (cuBLAS, bf16) over the "
        f"8 layers: {prod_ms:.4f} ms")
    torch.cuda.empty_cache()
    return totals, prod_ms, max_err


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

TRAIN_CROP = (384, 1280)
TRAIN_BATCH = 8
TRAIN_SCENES = 64
TRAIN_IM = (375, 1242)
# steps on one fixed batch for the falling-loss check, and the learning
# rate they use (the flagship's, no warmup). From random weights the loss
# first overshoots for a few steps (float32 on the CPU too), then falls:
# the check holds the mean of the last 3 steps against the first
FIXED_STEPS = 20
FIXED_LR = 0.002
# card (kernels, float32, TF32 off) against the CPU (plain, float64) after
# one train step of dla34 at 128x448 from zero-initialised DCN offsets,
# without weight decay, so each update is -lr times the gradient. Each
# tensor's update is compared with its own largest float64 update. The step
# is not smooth at float32 rounding's scale: the align modules' selections
# and the activations' kinks flip when the input moves by 1e-6, and the
# float64 step then moves by a median 4.5e-3 of each tensor's own update,
# 1.6e-1 in the worst tensor and 1.7e-2 of the largest update, its loss by
# 8.8e-6 (profile_train_noise.py). So the whole step is held by the median
# over tensors, against the largest update, and every tensor against a
# gross error; the 8 DCN layers' operand gradients, a smooth function of
# the operands the card step gave them, are held per tensor against the
# float64 plain backward. Each limit is about 2-3x the larger of the card's
# reading and the perturbed float64 step's (PERF.md gives both).
TRAIN_CPU_CROP = (128, 448)
TRAIN_CPU_TOL = {"loss": 3e-5, "bn_stats": 1e-4, "update_median": 1e-2,
                 "update_largest": 3e-2, "update_each": 0.5,
                 "dcn_grads": 1e-5}


def train_conf(crop, batch, dtype="bfloat16", backbone="dla102",
               num_scales=12):
    """The flagship's train configuration at `crop`: its anchors and
    whitening stats are left to the train split."""
    from m3dssd_tpu_torch.config import flagship_conf

    return flagship_conf(crop, num_scales=num_scales, backbone=backbone,
                         dtype=dtype).replace(
        anchors=None, bbox_means=None, bbox_stds=None, batch_size=batch)


_TRAIN_SET = None


def train_set(conf):
    """The train runs' in-memory split (TRAIN_SCENES synthetic scenes of
    TRAIN_IM, seed 7) for `conf`, whose anchors and whitening stats it
    sets. The scenes are drawn once; later calls reuse them, with the
    first call's anchors and stats."""
    import copy

    from m3dssd_tpu_torch.data.augment import Augmentation
    from m3dssd_tpu_torch.data.synthetic import SyntheticTrainSet

    global _TRAIN_SET
    if _TRAIN_SET is None:
        _TRAIN_SET = SyntheticTrainSet(conf, TRAIN_SCENES, seed=7,
                                       imW=TRAIN_IM[1], imH=TRAIN_IM[0])
        return _TRAIN_SET
    for k in ("anchors", "bbox_means", "bbox_stds"):
        setattr(conf, k, getattr(_TRAIN_SET.conf, k))
    ds = copy.copy(_TRAIN_SET)
    ds.conf, ds.transform = conf, Augmentation(conf)
    return ds


def bwd_counts():
    from m3dssd_tpu_torch.ops import dcn_cuda

    return {"forward": dcn_cuda.launches, **dcn_cuda.bwd_launches}


def reset_counts():
    from m3dssd_tpu_torch.ops import dcn_cuda

    dcn_cuda.launches = 0
    for k in dcn_cuda.bwd_launches:
        dcn_cuda.bwd_launches[k] = 0


def sync_s(fn):
    """(result, host seconds) of fn() bracketed by synchronisations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_train(label):
    """The flagship's train path at 384x1280 bs=8 bf16 with packed input:
    TrainLoader over an in-memory synthetic split, make_train_step, a
    falling loss over FIXED_STEPS steps on one batch and the step's time
    split (the Trainer epoch runs in `phase_run_lifecycle`). Returns the
    kernels' launches {forward, cols, data, coord} over the phase's runs
    and the step's numbers."""
    from m3dssd_tpu_torch.data.loader import TrainLoader
    from m3dssd_tpu_torch.losses.rpn_loss import RPNLossConfig, rpn_3d_loss
    from m3dssd_tpu_torch.models import build
    from m3dssd_tpu_torch.train.state import (create_train_state,
                                              make_train_step)

    B = TRAIN_BATCH
    t0 = time.perf_counter()
    conf = train_conf(TRAIN_CROP, B).replace(warmup=0.0, lr=FIXED_LR)
    ds = train_set(conf)
    data_s = time.perf_counter() - t0
    loader = TrainLoader(ds, B, num_workers=8, seed=0, pack_s2d=True)
    t0 = time.perf_counter()
    batches = list(loader.batches(4))
    loader_ips = 4 * B / (time.perf_counter() - t0)
    check(batches[0]["images"].dtype == torch.bfloat16
          and tuple(batches[0]["images"].shape)
          == (B, TRAIN_CROP[0] // 2, TRAIN_CROP[1] // 2, 12)
          and batches[0]["images"].is_pinned(), "loader batch layout")

    model = build(conf, seed=0, phase="train")
    check(all(p.dtype == torch.float32 and p.requires_grad
              for p in model.parameters()), "train build: master weights")
    state = create_train_state(conf, model, max_iter=10 ** 6)
    check(abs(state.optimizer.lr() - FIXED_LR) < 1e-9,
          f"lr {state.optimizer.lr()}")
    step = make_train_step(conf, ds.rois, packed_input=True)
    launches = dict.fromkeys(("forward",) + BWD_KERNELS, 0)
    torch.cuda.reset_peak_memory_stats()

    def run(batch):
        reset_counts()
        stats = step(state, batch)
        loss = float(stats["loss"])
        n = bwd_counts()
        for k in launches:
            launches[k] += n[k]
        check(all(v == 8 for v in n.values()),
              f"train step launched {n}, expected 8 of each kernel")
        check(math.isfinite(loss), f"train step loss {loss}")
        return loss

    # finite gradients: one step's grads read before the update
    params = state.params()
    out = model(batches[0]["images"].cuda(), packed=True)
    loss, _ = rpn_3d_loss(out, {k: v.cuda() for k, v in batches[0].items()},
                          torch.as_tensor(ds.rois[:, :5], dtype=torch.float32,
                                          device="cuda"),
                          torch.as_tensor(conf.anchors, dtype=torch.float32,
                                          device="cuda"),
                          torch.as_tensor(conf.bbox_means, device="cuda"),
                          torch.as_tensor(conf.bbox_stds, device="cuda"),
                          RPNLossConfig.from_conf(conf))
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    bad = [n for n, g in zip(params, grads)
           if g is not None and not bool(torch.isfinite(g).all())]
    check(not bad, f"non-finite gradients in {bad[:5]}")
    unused = [n for n, g in zip(params, grads) if g is None]
    del out, loss, grads

    fixed = batches[0]
    losses, step_s = [], []
    for _ in range(FIXED_STEPS):
        loss, s = sync_s(lambda: run(fixed))
        losses.append(loss)
        step_s.append(s)
    check(sum(losses[-3:]) / 3 < losses[0], f"loss on a fixed batch did not "
          f"fall: {losses}")
    for b in batches[1:]:
        _, s = sync_s(lambda: run(b))
        step_s.append(s)
    warm = sorted(step_s[2:])
    step_ms = 1e3 * warm[len(warm) // 2]
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    # the step's time split, each part bracketed by synchronisations
    b = {k: v.cuda(non_blocking=True) for k, v in batches[1].items()}
    consts = (torch.as_tensor(ds.rois[:, :5], dtype=torch.float32,
                              device="cuda"),
              torch.as_tensor(conf.anchors, dtype=torch.float32,
                              device="cuda"),
              torch.as_tensor(conf.bbox_means, device="cuda"),
              torch.as_tensor(conf.bbox_stds, device="cuda"))
    cfg = RPNLossConfig.from_conf(conf)
    split = {k: [] for k in ("forward", "loss", "backward", "optimizer")}
    for _ in range(3):
        out, t_f = sync_s(lambda: model(b["images"], packed=True))
        (loss, _), t_l = sync_s(lambda: rpn_3d_loss(out, b, *consts, cfg))
        names = state.optimizer.names
        g, t_b = sync_s(lambda: torch.autograd.grad(
            loss, [params[n] for n in names], allow_unused=True))
        g = {n: torch.zeros_like(params[n]) if v is None else v
             for n, v in zip(names, g)}
        _, t_o = sync_s(lambda: state.optimizer.step(params, g))
        for k, v in zip(split, (t_f, t_l, t_b, t_o)):
            split[k].append(1e3 * v)
        del out, loss, g
    split = {k: sorted(v)[1] for k, v in split.items()}

    log(f"train {TRAIN_CROP[0]}x{TRAIN_CROP[1]} bs={B} bf16 packed "
        f"({label}): {TRAIN_SCENES} synthetic {TRAIN_IM[0]}x{TRAIN_IM[1]} "
        f"scenes built in {data_s:.1f} s; {len(unused)} parameters get no "
        "gradient" + (f" ({unused[:3]})" if unused else ""))
    log(f"  loss over {FIXED_STEPS} steps on one batch at lr {FIXED_LR}: "
        + ", ".join(f"{v:.4f}" for v in losses))
    log(f"  train step (loader batch -> updated weights) median of "
        f"{len(warm)} warm steps: {step_ms:.2f} ms = "
        f"{B * 1e3 / step_ms:.2f} im/s; peak device memory "
        f"{peak_gb:.2f} GiB; loader alone {loader_ips:.2f} im/s (8 threads)")
    log("  step split (synchronised, median of 3): " + ", ".join(
        f"{k} {v:.2f} ms" for k, v in split.items()))

    del model, state, batches
    torch.cuda.empty_cache()
    return launches, {"step_ms": step_ms, "im_s": B * 1e3 / step_ms,
                      "split_ms": split, "peak_gib": peak_gb,
                      "loader_im_s": loader_ips}


# --------------------------------------------------------------------------
# device targets, the run directory's lifecycle and upstream checkpoints
# --------------------------------------------------------------------------

# loader batches on which the device assignment is held against the host's
DT_BATCHES = 4
# train steps with the targets assigned on the card
DT_STEPS = 8
# the loader alone: batches per reading, readings of each kind (A B B A)
LOADER_BATCHES = 3
LOADER_ROUNDS = 2
# regression targets: device against host, relative to the largest
TARGET_TOL = 1e-5
GT_KEYS = ("gt_boxes2d", "gt_boxes3d", "gt_cls", "gt_valid", "ign_boxes",
           "ign_valid")
# validation images of the lifecycle's eval and test runs
LIFE_VAL = 16
# BN folded from the float32 checkpoint against the unfolded model: the
# FOLD_Q quantile of each output's |diff| from the float32 unfolded model,
# relative to its largest magnitude, at most FOLD_TOL in float32 and at most
# FOLD_BF16_RATIO times the unfolded bf16 model's own in bf16. The largest
# |diff| is left out: where an align threshold or an argmax flips under
# rounding, a few outputs move far. Set from `profile_fold.py`'s readings
# (PERF.md section 6)
FOLD_KEYS = ("cls", "bbox_2d", "bbox_3d")
FOLD_Q = 0.999
FOLD_TOL = 1e-4
FOLD_BF16_RATIO = 1.5


def compare_targets(dev, host, gts):
    """(images compared, images left out, fg anchors, mismatch messages)
    of a device assignment against the host targets of the same batch.
    An image with ignore boxes and no valid gt is left out: the host path
    makes all its rois bg, the reference package's device path ignored
    (ops/targets_device.py)."""
    valid = gts["gt_valid"].bool().any(1)
    igns = gts["ign_valid"].bool().any(1)
    bad, n, skipped, fg = [], 0, 0, 0
    for b in range(valid.shape[0]):
        if not valid[b] and igns[b]:
            skipped += 1
            continue
        n += 1
        for k in ("labels", "labels_fg", "labels_bg", "labels_ign",
                  "any_val"):
            d, h = dev[k][b].cpu(), host[k][b]
            if d.dtype != h.dtype or not torch.equal(d, h):
                bad.append(f"image {b} {k}: {int((d != h).sum())} differ")
        m = host["labels_fg"][b].bool()
        fg += int(m.sum())
        for k in ("bbox_2d", "bbox_3d"):
            d, h = dev[k][b].cpu()[:, m], host[k][b][:, m]
            if m.any():
                err = float((d - h).abs().max() / h.abs().max().clamp(
                    min=1e-6))
                if err > TARGET_TOL:
                    bad.append(f"image {b} {k}: {err:.2e} of the largest")
    return n, skipped, fg, bad


def loader_ips(loader, batches):
    t0 = time.perf_counter()
    for _ in loader.batches(batches):
        pass
    return batches * loader.batch_size / (time.perf_counter() - t0)


def phase_train_device_targets(label, host_step):
    """The flagship at 384x1280 bs=8 bf16 packed, `pre_compute_target`
    off: the device assignment held against the host targets on the same
    loader batches, DT_STEPS train steps with the targets assigned on the
    card, and the loader alone with and without host targets. Returns the
    kernels' launches over the steps."""
    import copy

    from m3dssd_tpu_torch.data.loader import TrainLoader
    from m3dssd_tpu_torch.models import build
    from m3dssd_tpu_torch.ops.targets_device import make_device_target_fn
    from m3dssd_tpu_torch.train.state import (create_train_state,
                                              make_train_step)

    B = TRAIN_BATCH
    conf = train_conf(TRAIN_CROP, B)
    ds = train_set(conf)
    dconf = conf.replace(pre_compute_target=False)
    ds_dev = copy.copy(ds)          # same scenes and augmentation, gts only
    ds_dev.conf = dconf

    def loaders():
        return (TrainLoader(ds, B, num_workers=8, seed=0, pack_s2d=True),
                TrainLoader(ds_dev, B, num_workers=8, seed=0, pack_s2d=True))

    host_l, dev_l = loaders()
    hb, db = list(host_l.batches(DT_BATCHES)), list(dev_l.batches(DT_BATCHES))
    assign = make_device_target_fn(dconf, ds.rois)
    n = skipped = fg = 0
    for h, d in zip(hb, db):
        check(torch.equal(h["images"], d["images"]),
              "device-target loader: other images than the host loader's")
        gts = {k: d[k].cuda() for k in GT_KEYS}
        ni, ns, nf, bad = compare_targets(assign(gts), h, gts)
        check(not bad, f"device targets against host targets: {bad[:5]}")
        n, skipped, fg = n + ni, skipped + ns, fg + nf
    check(n > 0 and fg > 0, f"device targets: {n} images, {fg} fg compared")
    gts = {k: db[0][k].cuda() for k in GT_KEYS}
    assign_ms = [cuda_ms(lambda: assign(gts), 10, warmup=2)
                 for _ in range(3)]

    model = build(dconf, seed=0, phase="train")
    state = create_train_state(dconf, model, max_iter=10 ** 6)
    step = make_train_step(dconf, ds.rois, packed_input=True)
    launches = dict.fromkeys(("forward",) + BWD_KERNELS, 0)
    losses, step_s = [], []
    # batches loaded first, as phase_train's: loader threads running beside
    # the step slow its launches
    for batch in list(dev_l.batches(DT_STEPS)):
        reset_counts()
        stats, s = sync_s(lambda: step(state, batch))
        cnt = bwd_counts()
        check(all(v == 8 for v in cnt.values()),
              f"device-target step launched {cnt}, expected 8 of each")
        for k in launches:
            launches[k] += cnt[k]
        losses.append(float(stats["loss"]))
        step_s.append(s)
    check(all(math.isfinite(v) for v in losses),
          f"device-target steps: losses {losses}")
    warm = sorted(step_s[2:])
    step_ms = 1e3 * warm[len(warm) // 2]
    del model, state, step
    torch.cuda.empty_cache()

    reads = {"host": [], "device": []}
    for kind in ("host", "device", "device", "host")[:2 * LOADER_ROUNDS]:
        host_l, dev_l = loaders()
        reads[kind].append(loader_ips(host_l if kind == "host" else dev_l,
                                      LOADER_BATCHES))
    log(f"device targets 384x1280 bs={B} ({label}): {n} images of "
        f"{DT_BATCHES} loader batches equal to the host targets (labels "
        f"and masks exact, {fg} fg anchors' boxes within {TARGET_TOL:g}); "
        f"{skipped} images with only ignore boxes left out")
    log(f"  assignment on the card: {', '.join(f'{v:.3f}' for v in assign_ms)}"
        f" ms per batch ({len(ds.rois)} anchors x {dconf.max_gts} gts)")
    log(f"  train step with device targets, median of {len(warm)} warm "
        f"steps: {step_ms:.2f} ms = {B * 1e3 / step_ms:.2f} im/s (host "
        f"targets, phase_train: {host_step:.2f} ms); losses "
        + ", ".join(f"{v:.4f}" for v in losses))
    for kind, v in reads.items():
        log(f"  loader alone, {'host' if kind == 'host' else 'no host'} "
            f"targets (8 threads, {LOADER_BATCHES} batches per reading): "
            + ", ".join(f"{x:.2f}" for x in v) + f" im/s (spread "
            f"{min(v):.2f}-{max(v):.2f})")
    return launches


def start_py(code):
    """Start `code` in a fresh Python process; `finish_py` collects it."""
    return subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def finish_py(proc, timeout=600):
    """Wait for a `start_py` process (killed at `timeout`); returns the JSON
    object its last output line prints."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise SmokeFailure(f"subprocess ran past {timeout} s")
    check(proc.returncode == 0, f"subprocess failed:\n{err[-3000:]}")
    return json.loads(out.strip().splitlines()[-1])


SNAPSHOT_TEST = """
import json, os, sys
sys.path.insert(0, {root!r})
from m3dssd_tpu_torch.scripts import test as cli
mod = cli.use_run_source({run!r})
from m3dssd_tpu_torch.data.synthetic import SyntheticEvalSet
from m3dssd_tpu_torch.ops import _build, dcn_cuda
conf = mod.load_conf({run!r})
val = SyntheticEvalSet(conf, {n}, seed=8, imW={imw}, imH={imh})
gt = val.write_labels(os.path.join({run!r}, "gt_test"))
dcn_cuda.launches = 0
res, sel = mod.run_test({run!r}, dataset=val, gt_path=gt)
print(json.dumps({{"source": mod.package_dir(), "dcn_cuda": dcn_cuda.__file__,
                  "libs": sorted(os.listdir(_build.BUILD_DIR)),
                  "build_dir": _build.BUILD_DIR,
                  "launches": dcn_cuda.launches,
                  "car_3d_r40": res.get("Car_3d_R40"), "sel": sel}}))
"""


def phase_run_lifecycle(label):
    """The run directory at full width (flagship, 384x1280 bs=8): the train
    CLI's function (one Trainer epoch: 8 steps, source snapshot, checkpoint,
    seed, eval on LIFE_VAL images), the test CLI's function from the run's
    source snapshot in a fresh process (its kernels built from the
    snapshot's csrc/), the export CLI's function (batched, packed, BN
    folded from the float32 checkpoint) and `load_detector`, its artifact
    against eager detect on the same folded weights and the folded model
    against the unfolded one, and a second artifact in the other align
    regime. Returns the kernels' launches."""
    import tempfile

    from m3dssd_tpu_torch.anchors import locate_anchors
    from m3dssd_tpu_torch.data.synthetic import SyntheticEvalSet
    from m3dssd_tpu_torch.inference import test_driver as drv
    from m3dssd_tpu_torch.inference.detect import make_batch_detector
    from m3dssd_tpu_torch.inference.export import (export_detector,
                                                   load_detector,
                                                   save_exported)
    from m3dssd_tpu_torch.models import bias_background, build, rpn
    from m3dssd_tpu_torch.models.layers import BatchNorm2d
    from m3dssd_tpu_torch.ops import dcn_cuda
    from m3dssd_tpu_torch.scripts import export_model as export_cli
    from m3dssd_tpu_torch.scripts import train as train_cli
    from m3dssd_tpu_torch.train.state import create_train_state
    from m3dssd_tpu_torch.utils.checkpoint import (is_seed_checkpoint,
                                                   latest_step,
                                                   read_model_weights,
                                                   restore_checkpoint)
    from m3dssd_tpu_torch.utils.fold_bn import fold_bn_eval

    B = TRAIN_BATCH
    launches = dict.fromkeys(("forward",) + BWD_KERNELS, 0)
    with tempfile.TemporaryDirectory() as tmp:
        run_dir = os.path.join(tmp, "run")
        # every NMS slot kept (the result writer drops the rows below
        # score_thres all the same), so the artifacts' compared rows are
        # real detections
        conf = train_conf(TRAIN_CROP, B).replace(
            max_epoch=1, snapshot_epoch=1, eval_epoch=1, eval_batch_size=B,
            display_iter=4, warmup=1.0 / 70, nms_score_stop=False)
        ds = train_set(conf)
        val = SyntheticEvalSet(conf, LIFE_VAL, seed=8, imW=TRAIN_IM[1],
                               imH=TRAIN_IM[0])
        reset_counts()
        tr, train_s = sync_s(lambda: train_cli.run_train(
            conf, None, run_dir, dataset=ds, val_dataset=val))
        n = bwd_counts()
        for k in launches:
            launches[k] += n[k]
        evals = 8 * (LIFE_VAL // B)
        check(tr.state.step == 8 and n["cols"] == 64
              and n["forward"] == 64 + evals,
              f"train CLI: {tr.state.step} steps, launches {n}")
        wdir = os.path.join(run_dir, "weights")
        check(latest_step(wdir) == 8, f"train CLI: snapshot "
              f"{latest_step(wdir)}")
        fresh = create_train_state(tr.conf, build(tr.conf, seed=1,
                                                  phase="train"), 8)
        restore_checkpoint(wdir, fresh)
        a, b2 = tr.state.model.state_dict(), fresh.model.state_dict()
        check(fresh.step == 8 and a.keys() == b2.keys()
              and all(torch.equal(a[k], b2[k]) for k in a),
              "train CLI: restored model differs")
        oa, ob = tr.state.optimizer.state_dict(), \
            fresh.optimizer.state_dict()
        check(oa["count"] == ob["count"] and oa["state"].keys()
              == ob["state"].keys() and all(
                  torch.equal(oa["state"][k]["momentum_buffer"],
                              ob["state"][k]["momentum_buffer"])
                  for k in oa["state"]),
              "train CLI: restored optimizer differs")
        check(all(math.isfinite(float(v)) for v in tr.last_stats.values()),
              f"train CLI: last step's stats {tr.last_stats}")
        snap = os.path.join(run_dir, "model_src", "m3dssd_tpu_torch")
        check(is_seed_checkpoint(run_dir) and os.path.exists(
            os.path.join(snap, "csrc", "dcn_shift.cu"))
            and not os.path.exists(os.path.join(snap, "_build")),
            "train CLI: no seed or no source snapshot with csrc/")
        txts = read_txts(os.path.join(run_dir, "results", "results_1",
                                      "data"))
        check(len(txts) == LIFE_VAL and tr.last_eval is not None
              and "Car_3d_R40" in tr.last_eval,
              f"train CLI eval: {len(txts)} result txts")
        rows = check_rows(txts, conf.lbls)
        log(f"lifecycle 384x1280 bs={B} ({label}): train CLI "
            f"{tr.state.step} steps, checkpoint (model and optimizer) "
            f"restored bit-identically, seed and source snapshot written, "
            f"eval {len(txts)} txts ({rows} rows), Car_3d_R40 "
            f"{tr.last_eval['Car_3d_R40']}; {train_s:.1f} s; kernel "
            f"launches {n}")

        # what the eval saw: after 8 steps the BN running statistics are
        # still 0.9^8 of their init, far from the batch statistics
        pack = drv._packer(conf, packed_input=True, pin=True)
        images = torch.cat([pack(val[i]["input"]) for i in range(B)]).cuda()
        ratio = []
        hooks = [m.register_forward_hook(
            lambda mod, inp, out: ratio.append(float(
                (inp[0].float().var((0, 2, 3), unbiased=False)
                 / mod.running_var).max())))
            for m in tr.model.modules() if isinstance(m, BatchNorm2d)]
        size = {}
        with torch.no_grad():
            for mode in ("eval", "train"):   # train mode last: it moves stats
                getattr(tr.model, mode)()
                out = tr.model(images, packed=True)
                for h in hooks:
                    h.remove()
                hooks = []
                size[mode] = max(float(out[k].float().abs().max())
                                 for k in ("bbox_2d", "bbox_3d"))
                check(math.isfinite(size[mode]),
                      f"trained model in {mode} mode: non-finite boxes")
        log(f"  after 8 steps, at {B} eval images: a BN input's batch "
            f"variance up to {max(ratio):.2f}x its running variance; "
            f"largest box output {size['eval']:.4f} in eval mode, "
            f"{size['train']:.4f} in train mode")
        del tr, fresh
        torch.cuda.empty_cache()

        # the test CLI runs in its own process while this one exports
        t_test = time.perf_counter()
        proc = start_py(SNAPSHOT_TEST.format(
            root=ROOT, run=run_dir, n=LIFE_VAL, imw=TRAIN_IM[1],
            imh=TRAIN_IM[0]))
        try:
            art = os.path.join(tmp, "det.pt2")
            ep, export_s = sync_s(lambda: export_cli.run_export(
                run_dir, art, batch_size=B, packed=True, fold_bn=True))
        finally:
            out = finish_py(proc)
        test_s = time.perf_counter() - t_test
        check(out["source"] == snap and out["dcn_cuda"].startswith(snap)
              and out["build_dir"].startswith(snap)
              and any(f.startswith("libdcn_shift-") for f in out["libs"]),
              f"test CLI did not run the snapshot's package: {out}")
        check(out["launches"] == evals and out["car_3d_r40"] is not None,
              f"test CLI from the snapshot: {out}")
        tdir = os.path.join(run_dir, "results", "results_test_8", "data")
        check(len(read_txts(tdir)) == LIFE_VAL, "test CLI: result txts")
        log(f"  test CLI from the run's snapshot (fresh process, kernels "
            f"built into {os.path.relpath(out['build_dir'], tmp)}): "
            f"{out['launches']} kernel launches, Car_3d_R40 "
            f"{out['car_3d_r40']}; {test_s:.1f} s, beside the export")

        det = load_detector(art)
        ops = sum(str(nd.target).startswith("m3dssd.dcn_shift")
                  for nd in ep.graph.nodes if nd.op == "call_function")
        check(ops == 8, f"exported graph: {ops} m3dssd.dcn_shift calls")
        check(det.meta["platforms"] == ["cuda"] and det.meta["packed_input"],
              f"artifact sidecar {det.meta}")
        images = images.float()         # the artifacts take float32 images
        sfs = torch.ones(B, device="cuda")
        rois = locate_anchors(conf.anchors, conf.feat_size, conf.feat_stride)
        weights, _ = read_model_weights(wdir)
        # BN folded from the float32 checkpoint against the unfolded model:
        # in float32 (the fold itself), and in bf16 against the float32
        # unfolded outputs (folding adds no more than bf16's own rounding)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        conf32 = conf.replace(compute_dtype="float32")
        outs, models = {}, {}
        for name, c, fold in (("f32", conf32, False),
                              ("f32 folded", conf32, True),
                              ("bf16", conf, False),
                              ("bf16 folded", conf, True)):
            m = build(c)
            m.load_state_dict(weights, strict=True)
            if fold:
                check(fold_bn_eval(m, weights) > 0, "fold_bn_eval: none")
            with torch.no_grad():
                o = m(images, packed=True)
            outs[name] = {k: o[k].float() for k in FOLD_KEYS}
            models[name] = m
        fold_err = {name: {q: max(_rel_quantile(outs[name][k],
                                                outs["f32"][k], q)
                                  for k in FOLD_KEYS) for q in (FOLD_Q, 1.0)}
                    for name in ("f32 folded", "bf16", "bf16 folded")}
        check(fold_err["f32 folded"][FOLD_Q] <= FOLD_TOL
              and fold_err["bf16 folded"][FOLD_Q]
              <= FOLD_BF16_RATIO * fold_err["bf16"][FOLD_Q],
              f"BN folded against unfolded, relative |diff| of the outputs "
              f"against the float32 unfolded model ({FOLD_Q} quantile, "
              f"largest): {fold_err}")
        unfolded = make_batch_detector(conf, rois, models["bf16"],
                                       packed_input=True)(images, sfs)
        # the artifact's weights
        eager = make_batch_detector(conf, rois, models["bf16 folded"],
                                    packed_input=True)
        del models, outs
        sels = []
        topm = rpn.confident_topm
        rpn.confident_topm = lambda *a: sels.append(topm(*a)) or sels[-1]
        try:
            want = eager(images, sfs)
        finally:
            rpn.confident_topm = topm
        cli_regime = "sparse" if sels[-1].ok else "dense"
        dcn_cuda.launches = 0
        got = det(images, sfs)
        torch.cuda.synchronize()
        check(dcn_cuda.launches == 8, f"artifact: {dcn_cuda.launches} "
              "kernel launches in one call")
        launches["forward"] += dcn_cuda.launches
        nvalid = int((want[..., 4] > 0).sum())
        check(tuple(got.shape) == (B, conf.nms_topN_post, 14)
              and bool(torch.isfinite(got).all()) and nvalid > 0
              and torch.equal(got, want), "export CLI artifact against "
              "eager on the same folded weights: not the same dets")
        same_u = torch.equal(got, unfolded)
        art_ms = [cuda_ms(lambda: det(images, sfs), 5, warmup=2)
                  for _ in range(2)]
        eager_ms = [cuda_ms(lambda: eager(images, sfs), 5, warmup=2)
                    for _ in range(2)]
        log(f"  export CLI (batched, packed, BN folded from the float32 "
            f"checkpoint): {export_s:.1f} s, "
            f"{det.meta['bytes'] / 2 ** 20:.1f} MiB, {ops} m3dssd.dcn_shift "
            f"calls; {cli_regime} align regime (trained 8 steps); on {B} val "
            f"images equal to eager on the same folded weights ({nvalid} "
            f"valid rows, bit for bit); outputs ({', '.join(FOLD_KEYS)}) "
            f"against the float32 unfolded model, relative |diff| at the "
            f"{FOLD_Q} quantile (largest): " + ", ".join(
                f"{name} {v[FOLD_Q]:.3e} ({v[1.0]:.3e})"
                for name, v in fold_err.items())
            + f" (limits: float32 folded {FOLD_TOL:g}, bf16 folded "
            f"{FOLD_BF16_RATIO:g}x bf16's); dets equal to the unfolded bf16 "
            f"model's: {same_u}; "
            f"artifact {', '.join(f'{v:.2f}' for v in art_ms)} ms per call, "
            f"eager {', '.join(f'{v:.2f}' for v in eager_ms)} ms ({label})")
        del det, ep, eager

        # the other align regime: a fresh model (every position confident:
        # dense) or a background-biased one (none confident: sparse)
        regime = "sparse" if cli_regime == "dense" else "dense"
        m = perturb_neck_offsets(build(conf, seed=0), seed=1)
        if regime == "sparse":
            bias_background(m, conf.num_classes, 4.0)
        eager = make_batch_detector(conf, rois, m, packed_input=True)
        ep, ex_s = sync_s(lambda: export_detector(
            conf, rois, m, batch_size=B, packed_input=True))
        path = os.path.join(tmp, f"{regime}.pt2")
        save_exported(ep, path, conf=conf, batch_size=B, packed_input=True)
        det = load_detector(path)
        dcn_cuda.launches = 0
        got = det(images, sfs)
        torch.cuda.synchronize()
        n_art = dcn_cuda.launches
        launches["forward"] += n_art
        sels = []
        rpn.confident_topm = lambda *a: sels.append(topm(*a)) or sels[-1]
        try:
            want = eager(images, sfs)
        finally:
            rpn.confident_topm = topm
        seen = "sparse" if sels[-1].ok else "dense"
        nvalid = int((want[..., 4] > 0).sum())
        check(seen == regime and n_art == 8 and nvalid > 0
              and torch.equal(got, want),
              f"{regime} artifact against eager: ran the {seen} align, "
              f"{n_art} launches, {nvalid} valid rows, same dets "
              f"{torch.equal(got, want)}")
        art_ms = [cuda_ms(lambda: det(images, sfs), 5, warmup=2)
                  for _ in range(2)]
        eager_ms = [cuda_ms(lambda: eager(images, sfs), 5, warmup=2)
                    for _ in range(2)]
        log(f"  {regime} align regime ({'fresh init' if regime == 'dense' else 'bias_background(4.0)'}): "
            f"export {ex_s:.1f} s; artifact equals eager ({nvalid} valid "
            f"rows, bit for bit); {n_art} kernel launches per call; artifact "
            f"{', '.join(f'{v:.2f}' for v in art_ms)} ms per call, eager "
            f"{', '.join(f'{v:.2f}' for v in eager_ms)} ms ({label})")
        del m, eager, ep, det
        torch.cuda.empty_cache()
    return launches


def phase_upstream(label):
    """A checkpoint of the original model: the card model's weights
    written in the original names and layouts with the port's key map,
    imported back bit-equal, the conf pinned to the gather DCN, and one
    detect under it (no shift-DCN kernel: the neck runs `dcn_v2`)."""
    from m3dssd_tpu_torch.anchors import locate_anchors
    from m3dssd_tpu_torch.config import flagship_conf
    from m3dssd_tpu_torch.inference.detect import make_batch_detector
    from m3dssd_tpu_torch.models import build
    from m3dssd_tpu_torch.models.necks import DCN
    from m3dssd_tpu_torch.ops import dcn_cuda
    from m3dssd_tpu_torch.utils.torch_import import (
        load_reference_checkpoint, pin_parity_conf)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_reference_layout import reference_state_dict

    conf = flagship_conf(TRAIN_CROP)
    A, C = conf.anchors.shape[0], conf.num_classes
    model = perturb_neck_offsets(build(conf, seed=0), seed=1)
    sd = reference_state_dict(model, A, C, block="bottleneck")
    pinned = pin_parity_conf(conf, sd)
    m2 = build(pinned, seed=5)
    got, stats = load_reference_checkpoint(m2, sd, A, C, block="bottleneck")
    mine = model.state_dict()
    equal = all(torch.equal(got[k], mine[k]) for k in mine
                if not k.endswith("num_batches_tracked"))
    check(equal and stats["loaded"] == len(sd) and not stats["missing"]
          and not stats["unmapped"] and not stats["shape_mismatch"],
          f"upstream round trip: equal {equal}, loaded {stats['loaded']} of "
          f"{len(sd)}, unmapped {stats['unmapped'][:3]}")
    check(pinned.dcn_shift_clamp is None and not any(
        m.uses_shift for m in m2.modules() if isinstance(m, DCN)),
        "pin_parity_conf did not pin dcn_shift_clamp=None")
    m2.load_state_dict(got, strict=True)
    rois = locate_anchors(conf.anchors, conf.feat_size, conf.feat_stride)
    B = TRAIN_BATCH
    images = packed_images(B, *TRAIN_CROP, seed=2, device="cuda")
    dcn_cuda.launches = 0
    dets = make_batch_detector(pinned, rois, m2, packed_input=True)(
        images, torch.ones(B, device="cuda"))
    check(dcn_cuda.launches == 0 and bool(torch.isfinite(dets).all())
          and tuple(dets.shape) == (B, conf.nms_topN_post, 14),
          f"pinned detect: {dcn_cuda.launches} launches")
    log(f"upstream checkpoint 384x1280 ({label}): {len(sd)} tensors in the "
        f"original layout imported back bit-equal; dcn_shift_clamp pinned to "
        f"None; detect bs={B} on the gather DCN: dets finite, 0 shift-DCN "
        "kernel launches")
    del model, m2
    torch.cuda.empty_cache()


def update_errors(after, before, ref_after, names):
    """({name: max|d - d_ref| / max|d_ref|}, max|d - d_ref| over all
    relative to the largest |d_ref|), d = after - before the step's update,
    over the tensors whose reference update is at least 1e-6 of the largest:
    the rest (conv biases before a BatchNorm) have a zero gradient."""
    upd = {n: ref_after[n].double() - before[n].double() for n in names}
    top = max(float(u.abs().max()) for u in upd.values())
    own, diff = {}, 0.0
    for n, u in upd.items():
        size = float(u.abs().max())
        if size < 1e-6 * top:
            continue
        d = float((after[n].double() - before[n].double() - u).abs().max())
        own[n] = d / size
        diff = max(diff, d)
    return own, diff / top


def phase_train_card_vs_cpu():
    """One train step of the flagship on dla34 at 128x448 from the same
    weights (DCN offset convs zero, so every neck offset is exactly 0) and
    the same batch, without weight decay: on the card through the kernels
    in float32 (TF32 off) and on the CPU through the plain ops in float64.
    Then each of the card step's 8 DCN backward calls again on the CPU: the
    float64 plain backward on the operands the card gave, per tensor
    against what the kernels returned. Returns the errors."""
    from m3dssd_tpu_torch.data.loader import TrainLoader
    from m3dssd_tpu_torch.data.synthetic import SyntheticTrainSet
    from m3dssd_tpu_torch.models import build
    from m3dssd_tpu_torch.ops import dcn_cuda
    from m3dssd_tpu_torch.ops.dcn import dcn_v2_shift_backward_reference
    from m3dssd_tpu_torch.train.state import (create_train_state,
                                              make_train_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    H, W = TRAIN_CPU_CROP
    conf = train_conf(TRAIN_CPU_CROP, 2, dtype="float32", backbone="dla34",
                      num_scales=4).replace(warmup=0.0, weight_decay=0.0)
    ds = SyntheticTrainSet(conf, 32, seed=9, imW=W, imH=H, min_h_px=10)
    batch = next(TrainLoader(ds, 2, num_workers=2, seed=1, pack_s2d=True,
                             pin=False).batches(1))
    init = build(conf, device="cpu", seed=0, phase="train").state_dict()
    after, stats, calls = {}, {}, []
    real = dcn_cuda.dcn_v2_shift_backward_cuda

    def spy(x, offset, mask, weight, g, *, clamp=1.0):
        out = real(x, offset, mask, weight, g, clamp=clamp)
        calls.append(([t.detach().cpu() for t in (x, offset, mask, weight,
                                                   g)],
                      [t.detach().cpu() for t in out], clamp))
        return out

    for key, dev, dtype in (("card", "cuda", torch.float32),
                            ("cpu64", "cpu", torch.float64)):
        model = build(conf, device=dev, seed=0, phase="train").to(dtype)
        state = create_train_state(conf, model, max_iter=10 ** 6)
        step = make_train_step(conf, ds.rois, packed_input=True)
        reset_counts()
        dcn_cuda.dcn_v2_shift_backward_cuda = spy
        try:
            stats[key] = {k: float(v) for k, v in step(state, batch).items()}
        finally:
            dcn_cuda.dcn_v2_shift_backward_cuda = real
        if dev == "cuda":
            n = bwd_counts()
            check(all(v == 8 for v in n.values()), f"card step launched {n}")
        after[key] = {k: v.detach().cpu() for k, v in
                      model.state_dict().items()}
    check(stats["cpu64"]["fg_count"] > 0, "card vs CPU batch has no "
          "sampled fg")
    check(len(calls) == 8, f"{len(calls)} DCN backward calls on the card")
    pnames = [n for n, _ in build(conf, device="cpu",
                                  phase="train").named_parameters()]
    stat_names = [n for n in init if n.endswith(("running_mean",
                                                 "running_var"))]
    own, largest = update_errors(after["card"], init, after["cpu64"], pnames)
    vals = sorted(own.values())
    dcn = {n: e for n, e in own.items() if "DCN_0" in n}
    errs = {"loss": abs(stats["card"]["loss"] - stats["cpu64"]["loss"])
            / abs(stats["cpu64"]["loss"]),
            "bn_stats": max(float((after["card"][n].double()
                                   - after["cpu64"][n]).abs().max()
                                  / after["cpu64"][n].abs().max()
                                  .clamp(min=1e-12)) for n in stat_names),
            "update_median": vals[len(vals) // 2],
            "update_largest": largest,
            "update_each": vals[-1]}

    # the kernels' gradients against the float64 plain backward, per
    # operand of each call, relative to that gradient's largest magnitude
    ties, dcn_grads = 1.0, {}
    for i, (ops, got, clamp) in enumerate(calls):
        x, off, mask, w, g = ops
        ties = min(ties, float((off == 0).float().mean()))
        want = dcn_v2_shift_backward_reference(
            x.double(), off.double(), mask.double(), w.double(), g.double(),
            clamp=clamp)
        for name, a, b in zip(("dx", "doffset", "dmask", "dweight"), got,
                              want):
            scale = float(b.abs().max())
            check(scale > 0, f"DCN layer {i}: {name} is zero")
            dcn_grads[f"{i}.{name}"] = float((a.double() - b).abs().max()) \
                / scale
    check(ties == 1.0, f"card step's DCN offsets not all 0 ({ties})")
    errs["dcn_grads"] = max(dcn_grads.values())
    for k, lim in TRAIN_CPU_TOL.items():
        check(errs[k] <= lim, f"train step card vs CPU float64: {k} error "
              f"{errs[k]} above {lim}")
    worst = sorted(((e, n) for n, e in own.items()), reverse=True)[:3]
    log(f"train step card (kernels, float32) vs CPU (plain, float64) at "
        f"{H}x{W} dla34, zero DCN offsets, no weight decay: loss "
        f"{stats['card']['loss']:.6f} vs {stats['cpu64']['loss']:.6f}; "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f"; per-tensor update errors over {len(vals)} tensors: p90 "
        f"{vals[int(0.9 * len(vals))]:.3e}, largest {worst}; the 8 DCN "
        f"layers' tensors {max(dcn.values()):.3e}")
    log("  DCN backward on the card step's operands vs float64 plain, "
        "relative max|diff| per call (dx doffset dmask dweight): "
        + "; ".join(" ".join(f"{dcn_grads[f'{i}.{n}']:.1e}" for n in
                             ("dx", "doffset", "dmask", "dweight"))
                    for i in range(len(calls))))
    return errs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    sys.path.insert(0, ROOT)
    from m3dssd_tpu_torch.ops import _build

    label = card_label()
    log(label)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    built = _build.build()
    log(f"built {', '.join(os.path.relpath(p, ROOT) for p, _ in built.values())}"
        f" from {', '.join(os.path.relpath(_build.SOURCES[n], ROOT) for n in built)}"
        f" in {time.perf_counter() - t0:.1f} s (one nvcc per source, in "
        "parallel)")
    for line in ptxas_summary("\n".join(r for _, r in built.values())):
        log(f"  {line}")
    hgmma = count_sass(built["dcn_shift"][0], "HGMMA")
    if hgmma is not None:
        log(f"  {hgmma} HGMMA (wgmma) instructions in the forward library's "
            "SASS")

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"phase {fn.__name__}: {time.perf_counter() - t0:.1f} s")
        return out

    dev = torch.device("cuda")
    totals, max_err = timed(phase_kernel_vs_plain, dev)
    bt, prod_ms, bwd_err = timed(phase_bwd_vs_plain, dev)
    # the forward kernel's launches on the main path, per phase
    fwd = {"detect": timed(phase_detect, label)}
    timed(phase_card_vs_cpu)
    fwd["eval"] = timed(phase_eval, label)
    train_launches, train_stats = timed(phase_train, label)
    timed(phase_train_card_vs_cpu)
    dt_launches = timed(phase_train_device_targets, label,
                        train_stats["step_ms"])
    life_launches = timed(phase_run_lifecycle, label)
    timed(phase_upstream, label)
    for name, n in (("train", train_launches), ("device_targets",
                                                dt_launches),
                    ("lifecycle", life_launches)):
        fwd[name] = n["forward"]
        if name != "train":
            for k in BWD_KERNELS:
                train_launches[k] += n[k]
    launches = sum(fwd.values())
    log("forward kernel launches (through m3dssd::dcn_shift) per phase: "
        + ", ".join(f"{k} {v}" for k, v in fwd.items()))

    # the forward kernel's numbers summed over one forward of each size:
    # the 384x1280 bs=1 and bs=8 (the eval and train runs') and the
    # 512x1760 bs=8 neck, 8 layers each
    fwd_t = {k: sum(t[k] for t in totals.values())
             for k in ("ms", "plain_ms", "bound_ms", "bytes_ms", "ops_ms")}
    kernels = [{
        "name": "dcn_v2_shift",
        "route": "cuda",
        "source": "m3dssd_tpu_torch/csrc/dcn_shift.cu",
        "replaces": "m3dssd_tpu/ops/dcn_pallas.py:133",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": fwd_t["ms"],
        "plain_ms": fwd_t["plain_ms"],
        "bound_ms": fwd_t["bound_ms"],
        "bound_by": ("bytes" if fwd_t["bytes_ms"] > fwd_t["ops_ms"]
                     else "operations"),
        "launches_by_phase": fwd,
        "library_ms": None,
        "forwards": {run: {k: t[k] for k in ("ms", "plain_ms", "bound_ms")}
                     for run, t in totals.items()},
    }]
    for k in BWD_KERNELS:
        t = bt[k]
        kernels.append({
            "name": f"dcn_shift_bwd_{k}",
            "route": "cuda",
            "source": "m3dssd_tpu_torch/csrc/dcn_shift_bwd.cu",
            "replaces": "m3dssd_tpu/ops/dcn.py:382",
            "launches": train_launches[k],
            "max_abs_err": bwd_err[k],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": ("bytes" if t["bytes_ms"] > t["ops_ms"]
                         else "operations"),
            "library_ms": None,
            "products_ms": prod_ms,
        })
    log(f"smoke run took {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
