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
with it, and drives a run directory's lifecycle on DLA-60 (DLA-102's
widths, less depth): the train CLI's function (one Trainer epoch with
snapshot, seed and eval), the test CLI's function
from the run's source snapshot in a fresh process, the export CLI's
function and `load_detector`, exported artifacts against eager detect in
both align regimes, and a checkpoint in the original model's layout
imported back under the pinned gather DCN. Data parallelism runs its
ranks in fresh processes: a train step of the flagship over two gloo ranks
on the one card (each on its 4 rows of the global batch; NCCL refuses two
ranks on one device) and over a one-rank NCCL group, in bf16 and in
float32, against the one-process step, the group BatchNorm alone against
the one-process BatchNorm at every BatchNorm shape of that step, and
`test_kitti_3d` over the two ranks against the one-process driver's
bytes. The spatial and model mesh axes run their ranks so too: at the
flagship's full width, a bf16 and a float32 train step and detect over
two gloo ranks with image height sharded (halo exchanges) and with the
wide layers' output channels sharded, against one process, every
shift-DCN call of those runs (at slab heights and Cout / 2) against the
plain version on its operands, with each rank's peak memory, parameter
and momentum bytes and step time. Then the train step with every
option on: dla34_depth at
512x1760 bs=8 bf16 with k-means anchors, photometric distortion in the
loader and both 3D loss branches, with host and device targets, every
DCN call of one such step against the plain version on its operands, the
3D-GIoU branch alone, ops/iou3d.py against the CPU in float64, and a
float32 card step against the float64 CPU step. Last, the quality and
serving CLIs' functions: learn_probe (DLA-34 at 384x1280 bs=4, variants
run2 and plain), convergence_check over an in-memory split (two epochs,
an eval after each, the train-split AP, and one more step whose DCN calls
are held against the plain version) and serve_check on the flagship at
512x1760 (the exported artifact against live detect). Every kernel's
launch count is set to 0 before a main-path run and read after it (a rank
process counts its own); each phase prints its seconds. Any failed check
ends the run with a non-zero exit code.

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


def eval_setup(device, n=EVAL_IMAGES):
    """The eval run's inputs: the flagship (bf16, seeded random weights,
    perturbed neck offsets) at EVAL_CROP, an in-memory synthetic split of
    `n` images of EVAL_IM, its batches packed and on the card, and
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
    B = EVAL_BATCH
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
            drv._run_batched(data, detect, conf, drv.txt_writer(d), B,
                             ev.pack, ev.device)
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
# the lifecycle's backbone: DLA-102's widths at less depth (trees of 2 and
# 3 levels where DLA-102 has 3 and 4), so that its two exports keep the
# whole run within its time
LIFE_BACKBONE = "dla60"
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
    """The run directory at full width (the flagship on LIFE_BACKBONE,
    384x1280 bs=8): the train CLI's function (one Trainer epoch: 8 steps,
    source snapshot, checkpoint, seed, eval on LIFE_VAL images), the test
    CLI's function from the run's source snapshot in a fresh process (its
    kernels built from the snapshot's csrc/), the export CLI's function
    (batched, packed, BN folded from the float32 checkpoint) and
    `load_detector`, its artifact against eager detect on the same folded
    weights and the folded model against the unfolded one, and a second
    artifact in the other align regime. Returns the kernels' launches."""
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
        conf = train_conf(TRAIN_CROP, B, backbone=LIFE_BACKBONE).replace(
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
        log(f"lifecycle {LIFE_BACKBONE} 384x1280 bs={B} ({label}): train "
            f"CLI {tr.state.step} steps, checkpoint (model and optimizer) "
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


def card_vs_cpu_step(conf, rois, batch, make_model, packed_input):
    """One train step from the same weights on the same batch: on the card
    through the kernels in float32 (TF32 off) and on the CPU through the
    plain ops in float64 (`make_model(device, dtype)` gives each its model,
    all with the same weights). Then each of the card step's 8 DCN backward
    calls again on the CPU: the float64 plain backward on the operands the
    card gave, per tensor against what the kernels returned. Checks every
    limit of TRAIN_CPU_TOL and returns (errors, per-tensor update errors,
    DCN gradient errors per call, stats of both steps)."""
    from m3dssd_tpu_torch.ops import dcn_cuda
    from m3dssd_tpu_torch.ops.dcn import dcn_v2_shift_backward_reference
    from m3dssd_tpu_torch.train.state import (create_train_state,
                                              make_train_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init = {k: v.detach().cpu().clone()
            for k, v in make_model("cpu", torch.float32).state_dict()
            .items()}
    after, stats, calls, pnames = {}, {}, [], None
    real = dcn_cuda.dcn_v2_shift_backward_cuda

    def spy(x, offset, mask, weight, g, *, clamp=1.0):
        out = real(x, offset, mask, weight, g, clamp=clamp)
        calls.append(([t.detach().cpu() for t in (x, offset, mask, weight,
                                                   g)],
                      [t.detach().cpu() for t in out], clamp))
        return out

    for key, dev, dtype in (("card", "cuda", torch.float32),
                            ("cpu64", "cpu", torch.float64)):
        model = make_model(dev, dtype)
        pnames = [n for n, _ in model.named_parameters()]
        state = create_train_state(conf, model, max_iter=10 ** 6)
        step = make_train_step(conf, rois, packed_input=packed_input)
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
        del model, state
    check(stats["cpu64"]["fg_count"] > 0, "card vs CPU batch has no "
          "sampled fg")
    check(len(calls) == 8, f"{len(calls)} DCN backward calls on the card")
    stat_names = [n for n in init if n.endswith(("running_mean",
                                                 "running_var"))]
    own, largest = update_errors(after["card"], init, after["cpu64"], pnames)
    vals = sorted(own.values())
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
    return errs, own, dcn_grads, stats


def dcn_calls_vs_plain(fn):
    """fn() with the shift-DCN forward and backward wrappers spied on: each
    call's result is held, on the card, against the plain version on the
    same operands in the call's own types (`dcn_v2_shift_reference` to TOL,
    as phase_kernel_vs_plain; `dcn_v2_shift_backward_reference` to
    BWD_TOL, as phase_bwd_vs_plain). The spies launch nothing themselves.
    Returns fn()'s result and, per call in order, (kind, (B, H, W, Cin,
    Cout), errors): the forward's max|diff| over max(1, scale), the
    backward's relative max|diff| of dx, doffset, dmask and dweight."""
    from m3dssd_tpu_torch.ops import dcn as tdcn
    from m3dssd_tpu_torch.ops import dcn_cuda

    fwd = dcn_cuda.dcn_v2_shift_cuda
    bwd = dcn_cuda.dcn_v2_shift_backward_cuda
    calls = []

    def spy_fwd(x, offset, mask, weight, bias=None, *, clamp=1.0):
        out = fwd(x, offset, mask, weight, bias, clamp=clamp)
        want = tdcn.dcn_v2_shift_reference(x, offset, mask, weight, bias,
                                           clamp=clamp)
        shape = tuple(x.shape) + (weight.shape[-1],)
        err = float((out.float() - want.float()).abs().max()) \
            / max(1.0, float(want.float().abs().max()))
        check(math.isfinite(err) and err <= TOL[x.dtype],
              f"forward kernel disagrees with plain on a step's operands at "
              f"{shape} clamp {clamp} {x.dtype}: {err}")
        calls.append(("forward", shape, [err]))
        return out

    def spy_bwd(x, offset, mask, weight, g, *, clamp=1.0):
        out = bwd(x, offset, mask, weight, g, clamp=clamp)
        want = tdcn.dcn_v2_shift_backward_reference(x, offset, mask, weight,
                                                    g, clamp=clamp)
        shape = tuple(x.shape) + (weight.shape[-1],)
        errs = []
        for name, a, b in zip(("dx", "doffset", "dmask", "dweight"), out,
                              want):
            scale = float(b.float().abs().max())
            err = float((a.float() - b.float()).abs().max()) \
                / max(scale, 1e-12)
            check(scale > 0 and math.isfinite(err)
                  and err <= BWD_TOL[x.dtype][name],
                  f"backward {name} disagrees with plain on a step's operands"
                  f" at {shape} clamp {clamp} {x.dtype}: {err} (scale "
                  f"{scale})")
            errs.append(err)
        calls.append(("backward", shape, errs))
        return out

    dcn_cuda.dcn_v2_shift_cuda = spy_fwd
    dcn_cuda.dcn_v2_shift_backward_cuda = spy_bwd
    try:
        return fn(), calls
    finally:
        dcn_cuda.dcn_v2_shift_cuda = fwd
        dcn_cuda.dcn_v2_shift_backward_cuda = bwd


def log_card_vs_cpu(what, errs, own, dcn_grads, stats):
    vals = sorted(own.values())
    worst = sorted(((e, n) for n, e in own.items()), reverse=True)[:3]
    dcn = [e for n, e in own.items() if "DCN_0" in n]
    log(f"{what}: loss {stats['card']['loss']:.6f} vs "
        f"{stats['cpu64']['loss']:.6f}; "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f"; per-tensor update errors over {len(vals)} tensors: p90 "
        f"{vals[int(0.9 * len(vals))]:.3e}, largest {worst}; the 8 DCN "
        f"layers' tensors {max(dcn):.3e}")
    calls = len(dcn_grads) // 4
    log("  DCN backward on the card step's operands vs float64 plain, "
        "relative max|diff| per call (dx doffset dmask dweight): "
        + "; ".join(" ".join(f"{dcn_grads[f'{i}.{n}']:.1e}" for n in
                             ("dx", "doffset", "dmask", "dweight"))
                    for i in range(calls)))


def phase_train_card_vs_cpu():
    """One train step of the flagship on dla34 at 128x448 from the same
    weights (DCN offset convs zero, so every neck offset is exactly 0) and
    the same batch, without weight decay, on the card in float32 and on the
    CPU in float64 (`card_vs_cpu_step`). Returns the errors."""
    from m3dssd_tpu_torch.data.loader import TrainLoader
    from m3dssd_tpu_torch.data.synthetic import SyntheticTrainSet
    from m3dssd_tpu_torch.models import build

    H, W = TRAIN_CPU_CROP
    conf = train_conf(TRAIN_CPU_CROP, 2, dtype="float32", backbone="dla34",
                      num_scales=4).replace(warmup=0.0, weight_decay=0.0)
    ds = SyntheticTrainSet(conf, 32, seed=9, imW=W, imH=H, min_h_px=10)
    batch = next(TrainLoader(ds, 2, num_workers=2, seed=1, pack_s2d=True,
                             pin=False).batches(1))

    def make_model(dev, dtype):
        return build(conf, device=dev, seed=0, phase="train").to(dtype)

    errs, own, dcn_grads, stats = card_vs_cpu_step(conf, ds.rois, batch,
                                                   make_model, True)
    log_card_vs_cpu(f"train step card (kernels, float32) vs CPU (plain, "
                    f"float64) at {H}x{W} dla34, zero DCN offsets, no weight "
                    "decay", errs, own, dcn_grads, stats)
    return errs


# --------------------------------------------------------------------------
# the train options: dla34_depth, k-means anchors, photometric distortion,
# the 3D-projection and 3D-GIoU loss branches (ops/iou3d.py)
# --------------------------------------------------------------------------

# dla34_depth's 16 row bands sit in levels 2-5 (strides 4-32), so the input
# height is a multiple of 512: the flagship's test scale
CAP_CROP = (512, 1760)
CAP_BATCH = 8
CAP_SCENES = 32
CAP_STEPS = 10
CAP_OPTIONS = dict(back_bone="dla34_depth", distort_prob=0.5,
                   cluster_anchors=1, bbox_3d_proj_lambda=1.0,
                   bbox_3d_iou_lambda=1.0)
# the float32 card step against the float64 CPU step (TRAIN_CPU_TOL)
CAP_CPU_CROP = (512, 128)
# ops/iou3d.py on the step's decoded boxes, card against CPU float64:
# float64 on both sides to float64 rounding; the loss's float32 on the card
# within 1e-5, as tests/test_torch_iou3d.py holds it
IOU3D_TOL = {torch.float64: 1e-9, torch.float32: 1e-5}
# the float32 GIoU gradient, relative to max(1, its largest magnitude): it
# jumps where a rounding moves a polygon vertex across an edge, so it is
# held two decades looser than the values
DGIOU_F32_TOL = 1e-3
NMS_THRESH, NMS_OUT = 0.3, 64


def _cap_batch(N, B, crop, seed):
    """A seeded random batch of host targets for N anchors, with a KITTI
    camera's p2_inv (the projection branch needs it)."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(size=(B, N))
    fg, ign = u < 0.03, u > 0.9
    labels = np.where(fg, rng.integers(1, 4, size=(B, N)), 0)
    p2 = np.array([[721.5377, 0.0, 609.5593, 44.85728],
                   [0.0, 721.5377, 172.854, 0.2163791],
                   [0.0, 0.0, 1.0, 0.002745884], [0.0, 0.0, 0.0, 1.0]])
    f32, i8 = np.float32, np.int8
    b = {"images": rng.normal(size=(B,) + tuple(crop) + (3,)).astype(f32),
         "labels": np.where(ign, 3000, labels).astype(np.int32),
         "labels_fg": fg.astype(i8), "labels_bg": (~fg & ~ign).astype(i8),
         "labels_ign": ign.astype(i8),
         "bbox_2d": (rng.normal(size=(B, 4, N)) * 0.5).astype(f32),
         "bbox_3d": (rng.normal(size=(B, 7, N)) * 0.5).astype(f32),
         "any_val": np.ones(B, np.int32),
         "p2_inv": np.stack([np.linalg.inv(p2)] * B).astype(f32)}
    return {k: torch.from_numpy(v) for k, v in b.items()}


def decoded_cam_boxes(model, conf, rois, batch):
    """The loss's camera-frame boxes [B*N, 7] of the model's predictions and
    of the batch's targets (through the loss's `decode_3d_t` and
    `cam_boxes_t`, as `rpn_3d_loss` builds them for the 3D-GIoU branch), the flat fg mask and the fg score, from a forward of `batch`
    (on the model's device, without autograd)."""
    from m3dssd_tpu_torch.losses.rpn_loss import cam_boxes_t, decode_3d_t

    dev = next(model.parameters()).device
    b = {k: v.to(dev) for k, v in batch.items()}
    with torch.no_grad():
        out = model(b["images"], packed=b["images"].shape[-1] == 12)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    decoded = decode_3d_t(f32(rois[:, :5]), f32(conf.anchors),
                          f32(conf.bbox_means)[0], f32(conf.bbox_stds)[0],
                          f32(out["bbox_3d"]), f32(b["bbox_3d"]))
    cams = [cam_boxes_t(d, f32(b["p2_inv"])).transpose(1, 2).reshape(-1, 7)
            for d in decoded]
    fg = b["labels_fg"].reshape(-1) > 0
    score = 1.0 - out["prob_t"][:, 0].float().reshape(-1)
    return cams[0], cams[1], fg, score


def iou3d_card_vs_cpu(pred, tgt, score):
    """giou_3d (values and gradients), boxes_iou3d and nms_bev on the card
    against the CPU in float64 on the same boxes; the card's float32 (the
    loss's type) against the CPU's float64. Returns the errors."""
    from m3dssd_tpu_torch.ops import iou3d

    def giou_grad(a, b):
        a = a.clone().requires_grad_()
        g, i = iou3d.giou_3d(a, b)
        (1.0 - g).sum().backward()
        return g.detach().cpu().double(), i.detach().cpu().double(), \
            a.grad.cpu().double()

    cpu = [t.detach().cpu().double() for t in (pred, tgt)]
    ref = giou_grad(*cpu)
    ref_pair = iou3d.boxes_iou3d(cpu[0][:256], cpu[1][:256])
    ref_nms = iou3d.nms_bev(cpu[0], score.cpu(), NMS_THRESH, NMS_OUT)
    errs = {}
    for dtype in (torch.float64, torch.float32):
        a, b = (t.detach().to(dtype) for t in (pred, tgt))
        got = giou_grad(a, b)
        for name, g, r in zip(("giou", "iou", "dgiou"), got, ref):
            errs[f"{name}_{str(dtype)[6:]}"] = float(
                (g - r).abs().max() / max(1.0, float(r.abs().max())))
        pair = iou3d.boxes_iou3d(a[:256], b[:256]).cpu().double()
        errs[f"iou3d_{str(dtype)[6:]}"] = float((pair - ref_pair).abs()
                                                .max())
        for k in ("giou", "iou", "iou3d"):
            check(errs[f"{k}_{str(dtype)[6:]}"] <= IOU3D_TOL[dtype],
                  f"iou3d card vs CPU float64: {k} in {dtype}: {errs}")
    check(errs["dgiou_float64"] <= IOU3D_TOL[torch.float64]
          and errs["dgiou_float32"] <= DGIOU_F32_TOL,
          f"iou3d card vs CPU float64: giou gradient {errs}")
    idx, valid = iou3d.nms_bev(pred.detach().double(), score, NMS_THRESH,
                               NMS_OUT)
    check(torch.equal(idx.cpu(), ref_nms[0])
          and torch.equal(valid.cpu(), ref_nms[1]),
          "nms_bev on the card differs from the CPU's")
    errs["nms_kept"] = int(ref_nms[1].sum())
    return errs


def phase_capabilities(label):
    """The flagship's train step with every option of the last slice on, at
    full width on the card: dla34_depth at 512x1760 bs=8 bf16, k-means
    anchors from the synthetic train split, TrainLoader with photometric
    distortion, both 3D loss branches; CAP_STEPS steps with host targets and
    as many with device targets (each launching every shift-DCN kernel once
    per neck layer), the same step with both lambdas at 0, one more step
    whose every DCN call is held against the plain version on its own
    operands (`dcn_calls_vs_plain`), the 3D-GIoU branch alone, ops/iou3d.py
    on the step's decoded boxes against the CPU in float64, and one float32
    step on the card against the float64 CPU step at 512x128 bs=2 with
    every option on. Returns the kernels' launches over the full-width
    steps."""
    import copy

    from m3dssd_tpu_torch import anchors as anc
    from m3dssd_tpu_torch import geometry as geo
    from m3dssd_tpu_torch.data.augment import Augmentation
    from m3dssd_tpu_torch.data.loader import TrainLoader
    from m3dssd_tpu_torch.data.synthetic import SyntheticTrainSet
    from m3dssd_tpu_torch.models import build
    from m3dssd_tpu_torch.models.necks import DCN
    from m3dssd_tpu_torch.ops import iou3d
    from m3dssd_tpu_torch.train.state import (create_train_state,
                                              make_train_step)

    B = CAP_BATCH
    conf = train_conf(CAP_CROP, B).replace(warmup=0.0, **CAP_OPTIONS)
    t0 = time.perf_counter()
    ds = SyntheticTrainSet(conf, CAP_SCENES, seed=11, imW=TRAIN_IM[1],
                           imH=TRAIN_IM[0])
    data_s = time.perf_counter() - t0
    ladder = np.stack([anc.anchor_center(s * r, s, conf.feat_stride)
                       for s in conf.anchor_scales
                       for r in conf.anchor_ratios])
    t0 = time.perf_counter()
    again = anc.cluster_anchors(conf, ladder, ds.imdb)
    kmeans_s = time.perf_counter() - t0
    check(np.array_equal(again, conf.anchors), "k-means anchors differ "
          "between two runs from one seed")
    A = conf.anchors.shape[0]
    check(conf.anchors.shape[1] == 9 and np.isfinite(conf.anchors).all(),
          f"k-means anchors {conf.anchors.shape}")
    norm = anc._normalized_gts(conf, ds.imdb)
    mean_iou = {k: float(geo.iou(a[:, :4], norm[:, :4]).max(0).mean())
                for k, a in (("kmeans", conf.anchors), ("ladder", ladder))}
    check(ds.rois.shape[0] == A * int(np.prod(conf.feat_size)),
          "rois do not follow the clustered anchor count")

    # one CPU build (125 M parameters) serves every model of the phase; a
    # train build differs from its float32 form only in the compute dtype
    t0 = time.perf_counter()
    init_model = build(conf.replace(compute_dtype="float32"), device="cpu",
                       seed=0, phase="train")
    build_s = time.perf_counter() - t0
    n_dcn = sum(isinstance(m, DCN) and m.uses_shift
                for m in init_model.modules())
    check(n_dcn == 8, f"dla34_depth's neck has {n_dcn} shift-DCN layers")
    check(init_model.num_anchors == A, "head width is not the clustered A")
    model = copy.deepcopy(init_model)
    model.base.base.compute_dtype = torch.bfloat16
    model.cuda()
    state = create_train_state(conf, model, max_iter=10 ** 6)
    launches = dict.fromkeys(("forward",) + BWD_KERNELS, 0)

    def run(step, batch, lam):
        reset_counts()
        stats, s = sync_s(lambda: step(state, batch))
        n = bwd_counts()
        for k in launches:
            launches[k] += n[k]
        check(all(v == n_dcn for v in n.values()),
              f"capabilities step launched {n}, expected {n_dcn} of each")
        stats = {k: float(v) for k, v in stats.items()}
        bad = [k for k, v in stats.items() if not math.isfinite(v)]
        check(not bad, f"non-finite stats {bad}: {stats}")
        if lam:
            check("loss_bbox3d_proj" in stats and "loss_bbox3d_iou" in stats,
                  f"3D loss branches missing: {sorted(stats)}")
            r = stats["loss_bbox3d_iou"] / conf.bbox_3d_iou_lambda
            check(0.0 <= r <= 2.0, f"loss_bbox3d_iou / lambda = {r}")
        return stats, 1e3 * s

    torch.cuda.reset_peak_memory_stats()
    runs, kept = {}, []
    for name, c in (("host", conf),
                    ("device", conf.replace(pre_compute_target=False))):
        d = copy.copy(ds)
        d.conf, d.transform = c, Augmentation(c)
        step = make_train_step(c, ds.rois, packed_input=True)
        loader = TrainLoader(d, B, num_workers=8, seed=1, pack_s2d=True)
        t0 = time.perf_counter()
        ms, last = [], None
        for batch in loader.batches(CAP_STEPS):
            check(("labels" in batch) == (name == "host"),
                  f"{name} targets: batch keys {sorted(batch)}")
            last, t = run(step, batch, True)
            ms.append(t)
            if name == "host" and len(kept) < 3:
                kept.append(batch)
        runs[name] = {"ms": sorted(ms[2:])[len(ms[2:]) // 2],
                      "wall_s": time.perf_counter() - t0, "stats": last}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    # the same steps with both lambdas at 0, alternated on the same batches
    step_on = make_train_step(conf, ds.rois, packed_input=True)
    c0 = conf.replace(bbox_3d_proj_lambda=0.0, bbox_3d_iou_lambda=0.0)
    step_off = make_train_step(c0, ds.rois, packed_input=True)
    ab = {"on": [], "off": []}
    for batch in kept:
        ab["on"].append(run(step_on, batch, True)[1])
        ab["off"].append(run(step_off, batch, False)[1])
    ab = {k: sorted(v)[len(v) // 2] for k, v in ab.items()}

    # one more step, each of its DCN calls against the plain version on the
    # card, on that call's operands (the offsets trained by the steps above)
    _, dcn_calls = dcn_calls_vs_plain(lambda: run(step_on, kept[0], True))
    kinds = [k for k, _, _ in dcn_calls]
    check(kinds.count("forward") == n_dcn and kinds.count("backward")
          == n_dcn, f"spied step made DCN calls {kinds}")

    # the 3D-GIoU branch alone on the step's boxes (every row, as the loss)
    pred, tgt, fg, score = decoded_cam_boxes(model, conf, ds.rois, kept[0])
    check(int(fg.sum()) > 0, "no fg anchors in the kept batch")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    def branch():
        p = pred.clone().requires_grad_()
        g, _ = iou3d.giou_3d(p, tgt)
        (1.0 - g).sum().backward()
        return p.grad

    grad = branch()
    check(bool(torch.isfinite(grad).all()), "3D-GIoU branch: non-finite "
          "gradient")
    giou_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    giou_ms = cuda_ms(branch, 5, warmup=1)
    rows = pred.shape[0]
    fg_idx = torch.nonzero(fg).reshape(-1)[:2048]
    ious = iou3d_card_vs_cpu(pred[fg_idx], tgt[fg_idx], score[fg_idx])
    del state, model, grad, pred, tgt, kept
    torch.cuda.empty_cache()

    # float32 on the card against float64 on the CPU, every option on
    H, W = CAP_CPU_CROP
    cc = conf.replace(crop_size=[H, W], test_scale=[H, W], batch_size=2,
                      compute_dtype="float32", weight_decay=0.0)
    rois = anc.locate_anchors(cc.anchors, cc.feat_size, cc.feat_stride)
    batch = _cap_batch(rois.shape[0], 2, (H, W), seed=3)

    def make_model(dev, dtype):
        return copy.deepcopy(init_model).to(dev, dtype)

    errs, own, dcn_grads, stats = card_vs_cpu_step(cc, rois, batch,
                                                   make_model, False)
    check("loss_bbox3d_iou" in stats["card"], "card vs CPU step without "
          "the 3D-GIoU branch")

    log(f"capabilities: dla34_depth {CAP_CROP[0]}x{CAP_CROP[1]} bs={B} bf16 "
        f"packed, every option on ({label}); {CAP_SCENES} synthetic "
        f"{TRAIN_IM[0]}x{TRAIN_IM[1]} scenes in {data_s:.1f} s; model "
        f"built in {build_s:.1f} s; {n_dcn} shift-DCN layers in the neck")
    log(f"  k-means anchors: {A} (ladder {ladder.shape[0]}), mean IoU with "
        f"the split's {norm.shape[0]} gts {mean_iou['kmeans']:.4f} (ladder "
        f"{mean_iou['ladder']:.4f}), {kmeans_s:.3f} s")
    for name, r in runs.items():
        log(f"  {CAP_STEPS} steps, {name} targets, distortion on: median of "
            f"{CAP_STEPS - 2} warm steps {r['ms']:.2f} ms = "
            f"{B * 1e3 / r['ms']:.2f} im/s; {r['wall_s']:.1f} s with the "
            "loader; last stats " + ", ".join(
                f"{k} {v:.4f}" for k, v in sorted(r["stats"].items())))
    log(f"  peak device memory over the steps {peak_gib:.2f} GiB")
    log(f"  the same batches, alternated: both lambdas on {ab['on']:.2f} ms,"
        f" both at 0 {ab['off']:.2f} ms")
    log("  one more step's shift-DCN calls vs plain on their operands, bf16 "
        "(B,H,W,Cin->Cout: forward max|diff|/max(1,scale); backward "
        "relative max|diff| of dx doffset dmask dweight): " + "; ".join(
            f"{k} {','.join(map(str, sh[:4]))}->{sh[4]} "
            + " ".join(f"{e:.1e}" for e in errs)
            for k, sh, errs in dcn_calls))
    log(f"  3D-GIoU branch alone (giou_3d forward + backward over all "
        f"{rows} rows): {giou_ms:.2f} ms, {giou_gib:.2f} GiB above its "
        "inputs")
    log("  ops/iou3d.py on the card vs CPU float64, the step's decoded fg "
        f"boxes ({len(fg_idx)}): " + ", ".join(
            f"{k} {v:.3e}" if isinstance(v, float) else f"{k} {v}"
            for k, v in ious.items()))
    log_card_vs_cpu(f"  train step card (kernels, float32) vs CPU (plain, "
                    f"float64) at {H}x{W} bs=2, every option on, zero DCN "
                    "offsets, no weight decay", errs, own, dcn_grads, stats)
    return launches


# --------------------------------------------------------------------------
# the quality and serving CLIs (scripts/learn_probe.py, convergence_check.py,
# serve_check.py) at their own full widths
# --------------------------------------------------------------------------

QUALITY_CROP = (384, 1280)
QUALITY_BATCH = 4
PROBE_IMAGES = 16
PROBE_STEPS = 25
CONV_TRAIN = 16
CONV_VAL = 8
CONV_EPOCHS = 2
SERVE_ITERS = 10


def shift_dcn_layers(conf):
    """The shift-DCN layers of `conf`'s model (a CPU build)."""
    from m3dssd_tpu_torch.models import build
    from m3dssd_tpu_torch.models.necks import DCN

    model = build(conf.replace(compute_dtype="float32"), device="cpu")
    return sum(isinstance(m, DCN) and m.uses_shift for m in model.modules())


def phase_quality_scripts(label):
    """The quality and serving CLIs' functions on the card: learn_probe
    (DLA-34 at 384x1280 bs=4 bf16 over PROBE_IMAGES in-memory images,
    variants run2 and plain, PROBE_STEPS steps each; every step's stats
    finite, run2 through the forward and the three backward kernels,
    plain through none), convergence_check in memory (CONV_TRAIN train and
    CONV_VAL val images, CONV_EPOCHS epochs with an eval after each, the
    train-split eval, the report through JSON; then one more step of its
    trainer with every DCN call held against the plain version on its
    operands) and serve_check --flagship (DLA-102 at 512x1760 bs=0: the
    exported artifact within 1e-3 of live detect, both through the
    forward kernel). Returns the kernels' launches."""
    import tempfile

    from m3dssd_tpu_torch.scripts import convergence_check as cc
    from m3dssd_tpu_torch.scripts import learn_probe as lp
    from m3dssd_tpu_torch.scripts import serve_check as sc

    launches = dict.fromkeys(("forward",) + BWD_KERNELS, 0)
    lines = []

    def counted(fn):
        reset_counts()
        out, s = sync_s(fn)
        n = bwd_counts()
        for k in launches:
            launches[k] += n[k]
        return out, s, n

    # learn_probe: run2 and plain over the same fixed batches
    conf = lp.make_conf(QUALITY_BATCH, "dla34", QUALITY_CROP)
    ds = cc.in_memory_train_set(lp.no_aug(conf), PROBE_IMAGES)
    n_dcn = shift_dcn_layers(lp.variant_conf(ds.conf, "run2"))
    check(n_dcn > 0, "learn_probe's run2 model has no shift-DCN layer")
    probe = {}
    for name in ("run2", "plain"):
        res, s, n = counted(lambda: lp.run_learn_probe(
            conf, dataset=ds, variants=(name,), steps=PROBE_STEPS,
            images=PROBE_IMAGES, log_every=PROBE_STEPS // 2, device="cuda",
            out=lines.append)[name])
        check(res["nonfinite_steps"] == 0 and all(
            math.isfinite(v) for v in res["stats"].values()),
            f"learn_probe {name}: {res['nonfinite_steps']} steps with a "
            f"non-finite stat; last {res['stats']}")
        want = n_dcn * PROBE_STEPS if name == "run2" else 0
        check(all(v == want for v in n.values()),
              f"learn_probe {name} launched {n}, expected {want} of each")
        probe[name] = (res, s, n)

    # convergence_check in memory, then one more step under the spies
    conf = cc.make_conf(epochs=CONV_EPOCHS, eval_epoch=1,
                        batch_size=QUALITY_BATCH, crop=QUALITY_CROP)
    train = cc.in_memory_train_set(conf, CONV_TRAIN)
    val, train_eval = cc.in_memory_eval_sets(conf, CONV_TRAIN, CONV_VAL)
    with tempfile.TemporaryDirectory() as tmp:
        (report, tr), conv_s, n = counted(lambda: cc.run_convergence_check(
            conf, None, os.path.join(tmp, "out"), device="cuda",
            dataset=train, val_dataset=val, train_eval_dataset=train_eval,
            log=lines.append))
        steps = CONV_EPOCHS * (CONV_TRAIN // QUALITY_BATCH)
        check(tr.state.step == steps and all(
            n[k] == n_dcn * steps for k in BWD_KERNELS)
            and n["forward"] > n_dcn * steps,
            f"convergence_check: {tr.state.step} steps, launches {n}")
        line = "CONVERGENCE_REPORT " + json.dumps(report, default=float)
        rep = json.loads(line.split(" ", 1)[1])
        traj = [t["val_car_3d_r40"] for t in rep["val_trajectory"]]
        check(len(traj) == CONV_EPOCHS and all(map(math.isfinite, traj))
              and math.isfinite(rep["train_car_3d_r40"])
              and len(rep["train_car_bbox_r40"]) == 3,
              f"convergence_check report {line}")
        batch = next(tr.loader.batches(1))
        _, dcn_calls = dcn_calls_vs_plain(
            lambda: tr.train_step(tr.state, batch, tr.generator))
        kinds = [k for k, _, _ in dcn_calls]
        check(kinds.count("forward") == n_dcn
              and kinds.count("backward") == n_dcn,
              f"convergence step made DCN calls {kinds}")
        del tr

    # serve_check --flagship: the served and the live detector each make
    # 1 compared, 2 warm and SERVE_ITERS timed calls, 8 forwards each
    srv, serve_s, n = counted(lambda: sc.run_serve_check(
        sc.make_conf(flagship=True), batch_size=0, iters=SERVE_ITERS,
        device="cuda", log=lines.append))
    check(srv["serve_check"] == "ok" and srv["max_abs_diff"] < sc.TOL,
          f"serve_check --flagship: {srv}")
    want = 8 * 2 * (3 + SERVE_ITERS)
    check(n["forward"] == want and all(n[k] == 0 for k in BWD_KERNELS),
          f"serve_check launched {n}, expected {want} forwards")

    log(f"quality scripts ({label}): learn_probe dla34 {QUALITY_CROP[0]}x"
        f"{QUALITY_CROP[1]} bs={QUALITY_BATCH} over {PROBE_IMAGES} "
        f"in-memory images, {PROBE_STEPS} steps per variant, {n_dcn} "
        "shift-DCN layers")
    for s in lines:
        if s.startswith(("RESULT", "[trajectory]", "[serve_check]")):
            log(f"  {s}")
    for name, (res, s, n) in probe.items():
        log(f"  learn_probe {name}: {s:.1f} s, {res['steps_per_s']:.2f} "
            f"steps/s, launches {n}")
    log(f"  convergence_check {CONV_TRAIN} train / {CONV_VAL} val, "
        f"{CONV_EPOCHS} epochs bs={QUALITY_BATCH}: {conv_s:.1f} s; {line}")
    log("  one more convergence step's shift-DCN calls vs plain on their "
        "operands, bf16 (forward max|diff|/max(1,scale); backward relative "
        "max|diff| of dx doffset dmask dweight): " + "; ".join(
            f"{k} {','.join(map(str, sh[:4]))}->{sh[4]} "
            + " ".join(f"{e:.1e}" for e in errs)
            for k, sh, errs in dcn_calls))
    log(f"  serve_check --flagship dla102 512x1760 bs=1: {serve_s:.1f} s "
        f"with the export; served {srv['latency_ms']:.3f} ms/call, eager "
        f"{srv['eager_ms']:.3f} ms/call, max|served - live| "
        f"{srv['max_abs_diff']:.3e}, artifact {srv['artifact_mb']:.1f} MB")
    return launches


# --------------------------------------------------------------------------
# data parallelism (parallel/): ranks in their own processes
# --------------------------------------------------------------------------

DP_RANKS = 2
DP_EVAL_IMAGES = 32
# steps of the one-rank NCCL process timed after its first (compared) one
DP_TIMED_STEPS = 6
# A data-parallel step (2 ranks x 4 rows over gloo, or 1 rank over NCCL)
# against the one-process step on the same 8 rows from the same weights.
# The ranks' convolutions see batches of 4, where cuDNN may sum in another
# order, and the group BatchNorm runs torch's fused batch-norm kernels
# with its own reductions where the one-process step calls cuDNN: the two
# agree to rounding (DP_BN_TOL below). The bf16 step is not smooth at bf16
# rounding's scale: the one-process step with about half of its input
# moved by one ulp moves its updates by a median 0.88 of each tensor's own
# and its BN statistics by 3.4e-2 of a tensor's largest, the one-rank NCCL
# step by 0.55 and 2.2e-2 (PERF.md section 6). So the bf16 step is held by
# its stats and BN statistics only, and the same step in float32 (TF32
# off) by its updates too, where rounding is 2^-16 smaller: there the
# one-process step repeated moves its updates by a median 6e-7, the
# data-parallel ones by 1e-2 (the selections and kinks that flip under
# float32 rounding, as profile_train_noise.py shows), while a gradient
# left unreduced would move them by about half. Updates: the median over
# tensors of each one's error against its own update, and the largest
# error against the largest update. Each limit was set at about 3x the
# largest reading of the first run (PERF.md section 6).
DP_TOL = {torch.bfloat16: {"stats": 2.5e-2, "bn_stats": 6e-2},
          torch.float32: {"stats": 5e-6, "bn_stats": 3e-4,
                          "update_median": 3e-2, "update_largest": 5e-2}}
# The group BatchNorm alone, on fixed operands at every BatchNorm shape of
# the flagship's step (global batch TRAIN_BATCH), against the model's
# one-process BatchNorm2d (cuDNN) on all rows: the output and dx (in the
# input's dtype), the scale and bias gradients summed over the ranks and
# the running statistics, each as max|diff| over the reference's largest
# magnitude. Both sides compute in float32 and round once, so bf16 outputs
# may flip by one ulp: the bf16 limit is two ulps (2^-7). The rows differ
# in mean and scale, so a rank's own statistics are far from the global
# ones and a missing reduction would show at order 1.
DP_BN_TOL = {torch.bfloat16: {"y": 2.0 ** -7, "dx": 2.0 ** -7,
                              "dweight": 1e-4, "dbias": 1e-4,
                              "running_mean": 1e-5, "running_var": 1e-5},
             torch.float32: {"y": 1e-5, "dx": 1e-5, "dweight": 1e-5,
                             "dbias": 1e-5, "running_mean": 1e-5,
                             "running_var": 1e-5}}


def dp_step(conf, ds, batch, dev, group, path, bn_shapes=None):
    """One train step of the flagship from the seed-0 weights on `batch`
    (this rank's rows) under `group`, in conf.compute_dtype (float32 with
    TF32 off); saves the model after it at `path`. Adds each BatchNorm's
    input (C, H, W) to the set `bn_shapes` if given. Returns (stats, the
    step, its train state, seconds)."""
    from m3dssd_tpu_torch.models.layers import BatchNorm2d

    from m3dssd_tpu_torch.models import build
    from m3dssd_tpu_torch.train.state import (create_train_state,
                                              make_train_step)

    def record(_module, args):
        bn_shapes.add(tuple(args[0].shape[1:]))

    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    if conf.compute_dtype == "float32":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    try:
        model = build(conf, device=dev, seed=0, phase="train", group=group)
        if bn_shapes is not None:
            for m in model.modules():
                if isinstance(m, BatchNorm2d):
                    m.register_forward_pre_hook(record)
        state = create_train_state(conf, model, max_iter=10 ** 6)
        step = make_train_step(conf, ds.rois, packed_input=True,
                               group=group)
        stats, s = sync_s(lambda: step(state, batch))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               path)
    return {k: float(v) for k, v in stats.items()}, step, state, s


def dp_bn_check(mesh, shapes, dtype):
    """The model's BatchNorm2d under the group on this rank's rows of a
    global batch of TRAIN_BATCH against the same layer without a group on
    all rows (cuDNN), forward and backward from the same seeded operands,
    at each (C, H, W) of `shapes`. Returns each DP_BN_TOL quantity's
    largest error over the shapes."""
    from m3dssd_tpu_torch.models.layers import batch_norm

    dev, B = mesh.device, TRAIN_BATCH
    b = B // mesh.size
    rows = slice(mesh.rank * b, (mesh.rank + 1) * b)
    scale = torch.arange(1, B + 1, device=dev,
                         dtype=torch.float32).view(B, 1, 1, 1)
    worst = dict.fromkeys(DP_BN_TOL[dtype], 0.0)
    for i, (C, H, W) in enumerate(sorted(shapes)):
        g = torch.Generator(device=dev).manual_seed(100 + i)

        def draw(offset):
            return (torch.randn(B, C, H, W, generator=g, device=dev) * scale
                    + offset).to(dtype).contiguous(
                memory_format=torch.channels_last)

        x, dy = draw(scale), draw(0.0)
        w = torch.randn(C, generator=g, device=dev)
        bias = torch.randn(C, generator=g, device=dev)
        got, ref = {}, {}
        for out, group, part in ((got, mesh.group, rows),
                                 (ref, None, slice(None))):
            bn = batch_norm(C).to(dev).train()
            bn.process_group = group
            with torch.no_grad():
                bn.weight.copy_(w)
                bn.bias.copy_(bias)
            xi = x[part].detach().requires_grad_()
            y = bn(xi)
            y.backward(dy[part])
            out.update(y=y.detach(), dx=xi.grad, dweight=bn.weight.grad,
                       dbias=bn.bias.grad, running_mean=bn.running_mean,
                       running_var=bn.running_var)
        for k in ("dweight", "dbias"):
            torch.distributed.all_reduce(got[k], group=mesh.group)
        ref["y"], ref["dx"] = ref["y"][rows], ref["dx"][rows]
        for k in worst:
            r = ref[k].float()
            e = float((got[k].float() - r).abs().max() / r.abs().max())
            worst[k] = max(worst[k], e)
        del x, dy, got, ref
    return worst


def dp_confs():
    """The flagship's train configuration in bf16 (the main path) and in
    float32, with the train split's anchors."""
    conf = train_conf(TRAIN_CROP, TRAIN_BATCH).replace(warmup=0.0,
                                                       lr=FIXED_LR)
    ds = train_set(conf)
    return ds, {torch.bfloat16: conf,
                torch.float32: conf.replace(compute_dtype="float32")}


def dp_rank(kind, rank, world, tmp):
    """One rank of `phase_data_parallel`, run in a fresh process by it.

    kind "gloo": one of DP_RANKS ranks in a gloo group on cuda:0 (NCCL
    refuses two ranks on one device, "Duplicate GPU detected"; gloo moves
    the CUDA tensors of all_reduce, broadcast and barrier through the
    host): a train step of the flagship in bf16 and one in float32 on its
    4 rows of the global batch (a sliced TrainLoader), the gradients'
    all-reduce timed alone, `dp_bn_check` at the step's BatchNorm shapes
    in both dtypes, then `test_kitti_3d` over DP_EVAL_IMAGES
    images with the eval weights the parent saved. kind "nccl": a world of
    1 through `init_distributed()` (NCCL, cuda:LOCAL_RANK): the same steps
    and checks on all 8 rows, and DP_TIMED_STEPS more bf16 steps timed.
    Writes its
    models after the steps to `tmp` and prints one JSON line."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    sys.path.insert(0, ROOT)
    from m3dssd_tpu_torch.anchors import locate_anchors
    from m3dssd_tpu_torch.config import flagship_conf
    from m3dssd_tpu_torch.data.loader import TrainLoader
    from m3dssd_tpu_torch.data.synthetic import SyntheticEvalSet
    from m3dssd_tpu_torch.inference.detect import make_batch_detector
    from m3dssd_tpu_torch.inference.test_driver import test_kitti_3d
    from m3dssd_tpu_torch.models import build
    from m3dssd_tpu_torch.parallel import (all_reduce_grads,
                                           init_distributed, make_mesh)

    store = "file://" + os.path.join(tmp, f"{kind}.store")
    if kind == "gloo":
        init_distributed("gloo", device="cuda:0", init_method=store)
        mesh = make_mesh(device="cuda:0")
    else:
        init_distributed(init_method=store)
        mesh = make_mesh()
    dev = mesh.device
    ds, confs = dp_confs()
    batch = next(TrainLoader(ds, TRAIN_BATCH, num_workers=8, seed=0,
                             pack_s2d=True, process_index=mesh.rank,
                             process_count=mesh.size).batches(1))
    out = {"rank": mesh.rank, "device": str(dev),
           "rows": int(batch["images"].shape[0]),
           "backend": torch.distributed.get_backend()}
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    shapes = set()
    stats, step, state, s = dp_step(
        confs[torch.bfloat16], ds, batch, dev, mesh.group,
        os.path.join(tmp, f"{kind}.bf16.rank{mesh.rank}.pt"), shapes)
    out["stats"] = {"bf16": stats}
    out["step_launches"] = bwd_counts()
    out["reduced_bytes"] = step.reduced_bytes
    out["first_step_ms"] = 1e3 * s
    launches = bwd_counts()
    if kind == "nccl":
        times = []
        for _ in range(DP_TIMED_STEPS):
            reset_counts()
            times.append(sync_s(lambda: step(state, batch))[1])
            n = bwd_counts()
            launches = {k: launches[k] + n[k] for k in launches}
        out["step_ms"] = 1e3 * sorted(times[1:])[len(times[1:]) // 2]
    else:
        params = state.params()
        grads = [torch.zeros_like(params[n]) for n in state.optimizer.names]
        ms = []
        for _ in range(3):
            torch.distributed.barrier()
            ms.append(1e3 * sync_s(lambda: all_reduce_grads(
                grads, mesh.group))[1])
        out["allreduce_ms"] = sorted(ms)[1]
        del grads
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    del step, state
    torch.cuda.empty_cache()
    reset_counts()
    stats, _, _, _ = dp_step(
        confs[torch.float32], ds, batch, dev, mesh.group,
        os.path.join(tmp, f"{kind}.f32.rank{mesh.rank}.pt"))
    out["stats"]["f32"] = stats
    n = bwd_counts()
    launches = {k: launches[k] + n[k] for k in launches}
    torch.cuda.empty_cache()
    out["bn_shapes"] = len(shapes)
    out["bn"] = {key: dp_bn_check(mesh, shapes, dt)
                 for key, dt in (("bf16", torch.bfloat16),
                                 ("f32", torch.float32))}
    torch.cuda.empty_cache()

    if kind == "gloo":
        econf = flagship_conf(EVAL_CROP)
        val = SyntheticEvalSet(econf, DP_EVAL_IMAGES, seed=5,
                               imW=EVAL_IM[1], imH=EVAL_IM[0])
        emodel = build(econf, device=dev, seed=0)
        emodel.load_state_dict(torch.load(os.path.join(tmp, "eval.pt"),
                                          map_location=dev))
        rois = locate_anchors(econf.anchors, econf.feat_size,
                              econf.feat_stride)
        detect = make_batch_detector(econf, rois, emodel, packed_input=True,
                                     device=dev)
        gt = os.path.join(tmp, "gt") if mesh.primary else None
        reset_counts()
        res, sel = test_kitti_3d(val, detect, econf,
                                 os.path.join(tmp, "dp_results"),
                                 gt_path=gt, batch_size=EVAL_BATCH,
                                 packed_input=True, mesh=mesh)
        out["eval_launches"] = bwd_counts()["forward"]
        launches["forward"] += out["eval_launches"]
        out["sel"] = sel
        out["res_is_none"] = res is None
    out["launches"] = launches
    torch.distributed.destroy_process_group()
    print(json.dumps(out), flush=True)


def start_rank(kind, rank, world, tmp):
    return start_py(f"import sys; sys.path.insert(0, {ROOT!r}); "
                    f"import chip_smoke; chip_smoke.dp_rank({kind!r}, "
                    f"{rank}, {world}, {tmp!r})")


def phase_data_parallel(label, single_ms):
    """Data parallelism on the card, each rank in a fresh process: a step
    of the flagship (384x1280, global bs=8, bf16, packed; then float32)
    over DP_RANKS gloo ranks on cuda:0, each on its 4 rows from a sliced
    TrainLoader, against the one-process step on the 8 rows (and that
    step repeated, and with its input moved by one ulp: the step's own
    spread); the same steps in a one-rank NCCL group through
    `init_distributed()`; the group BatchNorm alone in every rank; and
    `test_kitti_3d` over the DP_RANKS ranks on DP_EVAL_IMAGES images
    against the one-process driver's bytes. Returns the kernels' launches,
    summed over the ranks."""
    import tempfile
    from types import SimpleNamespace

    from m3dssd_tpu_torch.data.loader import TrainLoader
    from m3dssd_tpu_torch.inference import test_driver as drv
    from m3dssd_tpu_torch.models import build
    from m3dssd_tpu_torch.parallel import shard_batch

    B = TRAIN_BATCH
    ds, confs = dp_confs()
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        ev = eval_setup("cuda", DP_EVAL_IMAGES)
        torch.save(ev.model.state_dict(), os.path.join(tmp, "eval.pt"))
        ev.data.write_labels(os.path.join(tmp, "gt"))
        procs = [start_rank("gloo", r, DP_RANKS, tmp)
                 for r in range(DP_RANKS)]

        # meanwhile, the references in this process: the sliced loader's
        # rows, the one-process steps (the float32 one twice: its own
        # spread) and the one-process eval
        whole = next(TrainLoader(ds, B, num_workers=8, seed=0,
                                 pack_s2d=True).batches(1))
        for r in range(DP_RANKS):
            part = next(TrainLoader(ds, B, num_workers=8, seed=0,
                                    pack_s2d=True, process_index=r,
                                    process_count=DP_RANKS).batches(1))
            want = shard_batch(SimpleNamespace(rank=r, size=DP_RANKS),
                               whole)
            check(all(torch.equal(part[k], want[k]) for k in want),
                  f"data parallel: rank {r}'s loader rows differ from the "
                  "one-process batch's")
        model = build(confs[torch.bfloat16], device="cpu", seed=0,
                      phase="train")
        init = {k: v.detach().clone() for k, v in model.state_dict().items()}
        names = [n for n, _ in model.named_parameters()]
        del model
        # a witness of the bf16 step's own sensitivity: the same step with
        # about half of the input's elements moved by one bf16 ulp
        bits = whole["images"].view(torch.int16)
        moved = dict(whole, images=(bits + torch.randint(
            0, 2, bits.shape, generator=torch.Generator().manual_seed(11),
            dtype=torch.int16)).view(torch.bfloat16))
        single = {}
        for key, dt, batch in (("bf16", torch.bfloat16, whole),
                               ("bf16_again", torch.bfloat16, whole),
                               ("bf16_ulp", torch.bfloat16, moved),
                               ("f32", torch.float32, whole),
                               ("f32_again", torch.float32, whole)):
            single[key] = dp_step(confs[dt], ds, batch, dev, None,
                                  os.path.join(tmp, f"one.{key}.pt"))[0]
            torch.cuda.empty_cache()
        one = os.path.join(tmp, "one_process")
        _, one_sel = drv.test_kitti_3d(ev.data, ev.detect, ev.conf, one,
                                       gt_path=os.path.join(tmp, "gt"),
                                       batch_size=EVAL_BATCH,
                                       packed_input=True)
        del ev
        torch.cuda.empty_cache()
        ranks = sorted((finish_py(p) for p in procs),
                       key=lambda o: o["rank"])
        # the one-rank NCCL steps alone on the card, for their time
        nccl = finish_py(start_rank("nccl", 0, 1, tmp))

        def load(name):
            return torch.load(os.path.join(tmp, name))

        def errors(got, ref, ref_stats, stats):
            own, largest = update_errors(got, init, ref, names)
            vals = sorted(own.values())
            bn = max(float((got[n].double() - ref[n].double()).abs().max()
                           / ref[n].double().abs().max().clamp(min=1e-12))
                     for n in ref if n.endswith(("running_mean",
                                                 "running_var")))
            return {"stats": max(abs(stats[k] - v) / max(abs(v), 1e-6)
                                 for k, v in ref_stats.items()),
                    "bn_stats": bn, "update_median": vals[len(vals) // 2],
                    "update_largest": largest}

        errs = {}
        for dt, key in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            ref = load(f"one.{key}.pt")
            g0, g1 = load(f"gloo.{key}.rank0.pt"), load(
                f"gloo.{key}.rank1.pt")
            check(g0.keys() == g1.keys() and all(torch.equal(g0[k], g1[k])
                                                  for k in g0),
                  f"data parallel {key}: the two ranks' models differ")
            errs["gloo", key] = errors(g0, ref, single[key],
                                       ranks[0]["stats"][key])
            del g0, g1
            errs["nccl", key] = errors(load(f"nccl.{key}.rank0.pt"), ref,
                                       single[key], nccl["stats"][key])
        for who, key, base in (("again", "f32_again", "f32"),
                               ("again", "bf16_again", "bf16"),
                               ("ulp", "bf16_ulp", "bf16")):
            errs[who, key] = errors(load(f"one.{key}.pt"),
                                    load(f"one.{base}.pt"), single[base],
                                    single[key])
        txt_one = read_txts(one)
        txt_dp = read_txts(os.path.join(tmp, "dp_results"))

    log(f"data parallel, flagship {TRAIN_CROP[0]}x{TRAIN_CROP[1]} global "
        f"bs={B} packed ({label}): {DP_RANKS} gloo ranks on cuda:0 x "
        f"{B // DP_RANKS} rows, bf16 loss {ranks[0]['stats']['bf16']['loss']:.6f}"
        f" on both (one process {single['bf16']['loss']:.6f}); against the "
        "one-process step (each step from the same weights):")
    for (who, key), e in errs.items():
        log(f"  {who} {key}: " + ", ".join(f"{k} {v:.3e}"
                                           for k, v in e.items()))
    log(f"  gradient bytes all-reduced per step {ranks[0]['reduced_bytes']}"
        f" ({ranks[0]['reduced_bytes'] / 2 ** 20:.1f} MiB); gloo all-reduce"
        f" of them alone (through the host, not a training cost) "
        + ", ".join(f"rank {o['rank']} {o['allreduce_ms']:.2f} ms"
                    for o in ranks)
        + "; first bf16 step " + ", ".join(f"{o['first_step_ms']:.1f}"
                                           for o in ranks) + " ms")
    log("  (again: the one-process step repeated; ulp: the one-process "
        "bf16 step with about half of its input moved by one ulp, a "
        "witness of the step's own sensitivity; neither is checked)")
    for o in ranks + [nccl]:
        for key, e in o["bn"].items():
            log(f"  group BatchNorm alone, {o['backend']} rank {o['rank']} "
                f"({o['rows']} rows), {key}, {o['bn_shapes']} shapes, "
                "against one-process BatchNorm2d: " + ", ".join(
                    f"{k} {v:.3e}" for k, v in e.items()))
    log("  per rank: launches " + "; ".join(
        f"rank {o['rank']} {o['launches']}, peak {o['peak_gib']:.2f} GiB"
        for o in ranks))
    log(f"  one-rank NCCL group (init_distributed): bf16 "
        f"{nccl['step_ms']:.2f} ms per step (median of "
        f"{DP_TIMED_STEPS - 1} warm) against phase_train's {single_ms:.2f}"
        f" ms; peak {nccl['peak_gib']:.2f} GiB; launches "
        f"{nccl['launches']}")
    log(f"  test_kitti_3d over {DP_RANKS} gloo ranks, {DP_EVAL_IMAGES} "
        f"images bs={EVAL_BATCH}: rank 0 wrote {len(txt_dp)} txts, the "
        f"one-process driver {len(txt_one)}; metric "
        + ", ".join(str(o["sel"]) for o in ranks) + f" (one process "
        f"{one_sel})")
    for o in ranks:
        for key in ("bf16", "f32"):
            check(o["stats"][key] == ranks[0]["stats"][key], "data "
                  f"parallel {key}: the ranks report other stats")
        check(o["rows"] == B // DP_RANKS, f"rank {o['rank']}: {o['rows']}"
              " rows")
        check(all(v == 8 for v in o["step_launches"].values()),
              f"rank {o['rank']}: step launched {o['step_launches']}")
        check(o["eval_launches"] == 8 * 2, f"rank {o['rank']}: eval "
              f"launched {o['eval_launches']}")
        check(o["sel"] == one_sel, f"rank {o['rank']}: metric {o['sel']} "
              f"against the one process's {one_sel}")
    check(not ranks[0]["res_is_none"] and ranks[1]["res_is_none"],
          "data parallel eval: the AP dict off rank 0")
    check(nccl["backend"] == "nccl" and nccl["rows"] == B
          and all(v == 8 for v in nccl["step_launches"].values()),
          f"NCCL rank: {nccl}")
    check(len(txt_one) == DP_EVAL_IMAGES and txt_dp == txt_one,
          "data parallel eval: rank 0's txts differ from the one "
          "process's")
    for o in ranks + [nccl]:
        check(o["bn_shapes"] > 0, f"rank {o['rank']}: no BatchNorm shapes")
        for key, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            for k, lim in DP_BN_TOL[dt].items():
                check(o["bn"][key][k] <= lim, f"group BatchNorm "
                      f"({o['backend']} rank {o['rank']}, {key}) against "
                      f"BatchNorm2d: {k} error {o['bn'][key][k]} above {lim}")
    for (who, key), e in errs.items():
        if who in ("again", "ulp"):
            continue
        for k, lim in DP_TOL[torch.bfloat16 if key == "bf16"
                             else torch.float32].items():
            check(e[k] <= lim, f"data parallel ({who}, {key}) against one "
                  f"process: {k} error {e[k]} above {lim}")
    total = dict.fromkeys(("forward",) + BWD_KERNELS, 0)
    for o in ranks + [nccl]:
        for k in total:
            total[k] += o["launches"][k]
    return total


# The spatial and model mesh axes: the flagship's train step and detect
# on a mesh of MESH_RANKS gloo ranks on cuda:0 (one process each, like
# phase_data_parallel's), per layout (name, spatial, model), against one
# process on the same global batch (the data axis has one rank: every
# rank takes all of its rows). The compared steps and detects run a
# global batch of MESH_BATCH rows under the DCN spies (each spied call is
# checked against plain, which at TRAIN_BATCH rows would take most of the
# smoke's time); the memory and step times are read at the train cell's
# TRAIN_BATCH rows, in steps without spies.
MESH_LAYOUTS = (("spatial", 2, 1), ("model", 1, 2))
MESH_RANKS = 2
MESH_BATCH = 2
MESH_TIMED_STEPS = 2
# The step against the one-process step (`mesh_step_errors`): the stats;
# the BN statistics; the gradients, which are the step's new momentum
# buffers (the optimizer starts without any), as the median over tensors
# of each tensor's error against its own largest value and the largest
# error against the largest gradient; and the parameters in float32 ulps
# beyond what the gradients' difference moves them by (an update is some
# 1e-5 of its parameter, so one ulp is ~1e-2 of the update: differences
# of float32 parameters cannot hold an update closer). The slabs' and the
# channel slices' convolutions round otherwise than the whole layer's,
# and the train-mode BN layers carry that to 1e-3 to 1e-2 of the
# gradients (tests/test_torch_mesh_axes.py reads it layer by layer on the
# CPU, and the one-process float32 gradient's own error against float64
# at that size); the bf16 step is held by its stats and BN statistics, as
# phase_data_parallel holds it. Limits: MESH_TOL, set from the card
# readings PERF.md records. What the collectives carry is held bit for bit on
# the CPU (test_collectives_move_values_exactly).
MESH_TOL = {torch.bfloat16: {"stats": 2.5e-2, "bn_stats": 1e-1},
            torch.float32: {"stats": 3e-5, "bn_stats": 3e-4,
                            "grad_median": 3e-2, "grad_largest": 5e-2,
                            "param_ulps": 1.0}}
# Detect (score threshold 0: every image's nms_topN_post rows are kept,
# where the random weights clear the config's 0.75 nowhere) against the
# one process's in float32 (TF32 off) and bf16: the same number of kept
# rows, and each kept row's distance to the nearest kept row of the one
# process's on its image (`row_distances`; rows of scores within rounding
# of each other trade places in the NMS order). In float32 every row
# within the reference package's mesh-detect tolerance (tests/test_e2e.py,
# MESH_DET_TOL; read 0.142 and 0). In bf16, in units of one bf16 ulp
# (MESH_BF16_DET["tol"], rtol = atol = 2^-8): the median and the largest
# distance within MESH_BF16_DET's limits (read: median 0.9 / 1.0, largest
# 37.1 / 94.5 for spatial / model; one process's bf16 rows against its
# float32 rows: 0.7 and 35.1, from bf16's rounding of the box decode).
MESH_DET_TOL = dict(rtol=1e-4, atol=1e-3)
MESH_BF16_DET = {"tol": dict(rtol=2.0 ** -8, atol=2.0 ** -8),
                 "median": 4.0, "largest": 200.0}


def _tf32(on):
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def mesh_run(conf, ds, batch, images, dev, mesh, spy, tmp, tag):
    """The mesh phase's compared runs on one model (the flagship's train
    build from seed 0, on `mesh` when given): a bf16 step (under the DCN
    spies when `spy`); from the initial weights again a float32 step (TF32
    off); then eval-mode detect of `images` in float32 and in bf16. Saves
    the whole state and momentum after each step and the detections to
    `tmp` (rank 0 of a mesh). Returns the readings, the launches and the
    spied DCN calls."""
    from m3dssd_tpu_torch.inference.detect import make_batch_detector
    from m3dssd_tpu_torch.models import build
    from m3dssd_tpu_torch.train.state import (create_train_state,
                                              make_train_step)
    from m3dssd_tpu_torch.utils.checkpoint import whole_state

    def spied(fn):
        return dcn_calls_vs_plain(fn) if spy else (fn(), [])

    primary = mesh is None or mesh.primary
    out, calls = {}, []
    model = build(conf, device=dev, seed=0, phase="train", mesh=mesh)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    launches = dict.fromkeys(("forward",) + BWD_KERNELS, 0)

    def count():
        for k, v in bwd_counts().items():
            launches[k] += v

    for key, compute in (("bf16", torch.bfloat16), ("f32", None)):
        model.load_state_dict(init)
        model.base.base.compute_dtype = compute
        _tf32(compute is not None)
        state = create_train_state(conf, model, max_iter=10 ** 6)
        step = make_train_step(conf, ds.rois, packed_input=True, mesh=mesh)
        out["lr"] = state.optimizer.lr()
        reset_counts()
        stats, c = spied(lambda: step(state, batch))
        count()
        calls += c
        out[f"{key}_stats"] = {k: float(v) for k, v in stats.items()}
        if key == "bf16":
            out["spatial_active"] = step.on_slabs
        sd, opt = whole_state(state)
        if primary:
            torch.save({"state": {k: v.detach().cpu() for k, v in sd.items()},
                        "momentum": {n: st["momentum_buffer"].cpu()
                                     for n, st in opt["state"].items()}},
                       os.path.join(tmp, f"{tag}.{key}.pt"))
        del state, step, sd, opt
    model.load_state_dict(init)
    model.eval()
    sfs = torch.ones(images.shape[0])
    for key, compute in (("f32", None), ("bf16", torch.bfloat16)):
        model.base.base.compute_dtype = compute
        _tf32(compute is not None)
        detect = make_batch_detector(conf.replace(score_thres=0.0),
                                     ds.rois, model, packed_input=True,
                                     device=dev)
        reset_counts()
        dets, c = spied(lambda: detect(images, sfs))
        count()
        calls += c
        if primary:
            torch.save(dets.cpu(), os.path.join(tmp, f"{tag}.det_{key}.pt"))
    _tf32(True)
    return out, launches, calls


def mesh_memory(conf, ds, batch, dev, mesh):
    """Peak memory, parameter and momentum bytes of a bf16 train step at
    the batch's rows (the flagship's train build from seed 0, on `mesh`
    when given), then the median time of MESH_TIMED_STEPS more; no
    spies."""
    from m3dssd_tpu_torch.models import build
    from m3dssd_tpu_torch.train.state import (create_train_state,
                                              make_train_step)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    model = build(conf, device=dev, seed=0, phase="train", mesh=mesh)
    state = create_train_state(conf, model, max_iter=10 ** 6)
    step = make_train_step(conf, ds.rois, packed_input=True, mesh=mesh)
    first = sync_s(lambda: step(state, batch))[1]
    out = {"peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
           "param_bytes": sum(p.numel() * p.element_size()
                              for p in model.parameters()),
           "momentum_bytes": sum(t.numel() * t.element_size()
                                 for st in state.optimizer.state.values()
                                 for t in st.values()),
           "first_ms": 1e3 * first}
    times = [sync_s(lambda: step(state, batch))[1]
             for _ in range(MESH_TIMED_STEPS)]
    out["step_ms"] = 1e3 * sorted(times)[len(times) // 2]
    del model, state, step
    torch.cuda.empty_cache()
    return out


def row_distances(got, ref, tol=MESH_DET_TOL):
    """Each kept row (score >= 0) of `got` [B, R, 14]: its distance to the
    nearest kept row of `ref` of the same image, in units of `tol` (max
    over fields of |g - r| / (atol + rtol |r|)), sorted."""
    out = []
    for g, r in zip(got.double(), ref.double()):
        g, r = g[g[:, 4] >= 0], r[r[:, 4] >= 0]
        if not len(g):
            continue
        if not len(r):
            return [float("inf")] * len(g)
        d = (g[:, None] - r[None]).abs() / (tol["atol"]
                                            + tol["rtol"] * r[None].abs())
        out += d.amax(-1).amin(-1).tolist()
    return sorted(out)


def det_errors(got, ref, tol=MESH_DET_TOL):
    """(median, largest) of `row_distances` (0 without kept rows)."""
    d = row_distances(got, ref, tol) or [0.0]
    return d[len(d) // 2], d[-1]


def mesh_step_errors(got, ref, lr, stats, ref_stats):
    """A step against the one process's (see MESH_TOL): `got` and `ref` as
    `mesh_run` saves them."""
    names = list(ref["momentum"])
    zeros = {n: torch.zeros_like(v) for n, v in ref["momentum"].items()}
    own, largest = update_errors(got["momentum"], zeros, ref["momentum"],
                                 names)
    vals = sorted(own.values())
    ulps = 0.0
    for n in names:
        a, b = got["state"][n].double(), ref["state"][n].double()
        top = torch.maximum(a.abs(), b.abs()).float()
        ulp = (torch.nextafter(top, torch.full_like(top, float("inf")))
               - top).double()
        moved = lr * (got["momentum"][n].double()
                      - ref["momentum"][n].double()).abs()
        ulps = max(ulps, float(((a - b).abs() - moved).clamp(min=0)
                               .div(ulp).max()))
    bn = max(float((got["state"][n].double() - ref["state"][n].double())
                   .abs().max() / ref["state"][n].double().abs().max()
                   .clamp(min=1e-12))
             for n in ref["state"] if n.endswith(("running_mean",
                                                  "running_var")))
    return {"stats": max(abs(stats[k] - v) / max(abs(v), 1e-6)
                         for k, v in ref_stats.items()),
            "bn_stats": bn, "grad_median": vals[len(vals) // 2],
            "grad_largest": largest, "param_ulps": ulps}


def mesh_conf():
    return train_conf(TRAIN_CROP, MESH_BATCH).replace(warmup=0.0,
                                                      lr=FIXED_LR)


def mesh_inputs(conf):
    """(train split, global batch of MESH_BATCH rows, of TRAIN_BATCH rows,
    packed images to detect) of the mesh phase."""
    from m3dssd_tpu_torch.data.loader import TrainLoader

    ds = train_set(conf)
    small, big = (next(TrainLoader(ds, b, num_workers=4, seed=0,
                                   pack_s2d=True).batches(1))
                  for b in (MESH_BATCH, TRAIN_BATCH))
    images = packed_images(MESH_BATCH, *TRAIN_CROP, seed=21, device="cpu")
    return ds, small, big, images


def mesh_rank(layout, rank, world, tmp):
    """One rank of `phase_mesh_axes`, in a fresh process: a gloo group on
    cuda:0 laid out as `layout` of MESH_LAYOUTS, `mesh_run` under the DCN
    spies (every shift-DCN call of its steps and detects held against the
    plain version on its own operands), then `mesh_memory` at TRAIN_BATCH
    rows. Prints one JSON line."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    sys.path.insert(0, ROOT)
    from m3dssd_tpu_torch.parallel import init_distributed, make_mesh

    _, sp, mp = next(lay for lay in MESH_LAYOUTS if lay[0] == layout)
    init_distributed("gloo", device="cuda:0", init_method="file://"
                     + os.path.join(tmp, f"{layout}.store"))
    mesh = make_mesh(spatial=sp, model=mp, device="cuda:0")
    conf = mesh_conf()
    ds, small, big, images = mesh_inputs(conf)
    out, launches, calls = mesh_run(conf, ds, small, images, mesh.device,
                                    mesh, True, tmp, layout)
    out["memory"] = mesh_memory(conf.replace(batch_size=TRAIN_BATCH), ds,
                                big, mesh.device, mesh)
    out.update(rank=rank, coords=[mesh.rank, mesh.s, mesh.m],
               launches=launches, calls=calls)
    torch.distributed.destroy_process_group()
    print(json.dumps(out), flush=True)


def phase_mesh_axes(label):
    """The spatial and model mesh axes on the card, at the flagship's full
    width (DLA-102, 384x1280, packed): per layout of MESH_LAYOUTS,
    MESH_RANKS gloo ranks on cuda:0 in fresh processes run a bf16 and a
    float32 train step and detect in float32 and bf16 at a global batch of
    MESH_BATCH rows, against the same on one process (run first, alone on
    the card); every shift-DCN forward and backward call of the ranks'
    runs is held against the plain version on its own operands (the
    kernels at the slab heights and Cout/mp they see only here). Prints
    each rank's peak memory, parameter and momentum bytes and step times
    at TRAIN_BATCH rows against one process. Returns the kernels' launches
    in the ranks' compared runs."""
    import tempfile

    conf = mesh_conf()
    dev = torch.device("cuda")
    total = dict.fromkeys(("forward",) + BWD_KERNELS, 0)
    with tempfile.TemporaryDirectory() as tmp:
        ds, small, big, images = mesh_inputs(conf)
        one, _, _ = mesh_run(conf, ds, small, images, dev, None, False, tmp,
                             "one")
        one["memory"] = mesh_memory(conf.replace(batch_size=TRAIN_BATCH), ds,
                                    big, dev, None)
        torch.cuda.empty_cache()
        ranks = {}
        for layout, _, _ in MESH_LAYOUTS:
            procs = [start_py(
                f"import sys; sys.path.insert(0, {ROOT!r}); import "
                f"chip_smoke; chip_smoke.mesh_rank({layout!r}, {r}, "
                f"{MESH_RANKS}, {tmp!r})") for r in range(MESH_RANKS)]
            ranks[layout] = sorted((finish_py(p) for p in procs),
                                   key=lambda o: o["rank"])
        from m3dssd_tpu_torch.models import build
        from m3dssd_tpu_torch.models.necks import DCN

        model = build(conf, device="cpu", seed=0, phase="train")
        couts = {m.weight.shape[-1] for m in model.modules()
                 if isinstance(m, DCN)}
        del model
        errs, det = {}, {}
        for layout, _, _ in MESH_LAYOUTS:
            for key in ("bf16", "f32"):
                errs[layout, key] = mesh_step_errors(
                    torch.load(os.path.join(tmp, f"{layout}.{key}.pt")),
                    torch.load(os.path.join(tmp, f"one.{key}.pt")),
                    one["lr"], ranks[layout][0][f"{key}_stats"],
                    one[f"{key}_stats"])
            for key in ("f32", "bf16"):
                got = torch.load(os.path.join(tmp, f"{layout}.det_{key}.pt"))
                ref = torch.load(os.path.join(tmp, f"one.det_{key}.pt"))
                det[layout, key] = (got, ref)

    mem = one["memory"]
    log(f"mesh axes, flagship {TRAIN_CROP[0]}x{TRAIN_CROP[1]} packed "
        f"({label}), {MESH_RANKS} gloo ranks on cuda:0 per layout, against "
        f"one process; compared runs at global bs={MESH_BATCH}, memory and "
        f"step times at bs={TRAIN_BATCH}:")
    log(f"  one process: bf16 step {mem['step_ms']:.2f} ms (median of "
        f"{MESH_TIMED_STEPS}; first {mem['first_ms']:.1f}), peak "
        f"{mem['peak_gib']:.3f} GiB, parameters "
        f"{mem['param_bytes'] / 2 ** 20:.2f} MiB, momentum "
        f"{mem['momentum_bytes'] / 2 ** 20:.2f} MiB")
    for layout, _, _ in MESH_LAYOUTS:
        for o in ranks[layout]:
            m = o["memory"]
            log(f"  {layout} rank {o['rank']} (data, spatial, model) = "
                f"{tuple(o['coords'])}: bf16 step {m['step_ms']:.2f} ms "
                f"(first {m['first_ms']:.1f}), peak {m['peak_gib']:.3f} GiB "
                f"({m['peak_gib'] / mem['peak_gib']:.3f} of one process), "
                f"parameters {m['param_bytes'] / 2 ** 20:.2f} MiB "
                f"({m['param_bytes'] / mem['param_bytes']:.3f}), momentum "
                f"{m['momentum_bytes'] / 2 ** 20:.2f} MiB "
                f"({m['momentum_bytes'] / mem['momentum_bytes']:.3f}); "
                f"launches {o['launches']}")
        for key in ("bf16", "f32"):
            log(f"  {layout} {key} step: " + ", ".join(
                f"{k} {v:.3e}" for k, v in errs[layout, key].items()))
        shapes = sorted({(k, tuple(sh)) for o in ranks[layout]
                         for k, sh, _ in o["calls"]})
        worst = {}
        for o in ranks[layout]:
            for k, _, e in o["calls"]:
                worst[k] = [max(a, b) for a, b in
                            zip(worst.get(k, [0.0] * len(e)), e)]
        log(f"  {layout}: {sum(len(o['calls']) for o in ranks[layout])} "
            "shift-DCN calls held against plain on their operands, shapes "
            f"(B, H, W, Cin, Cout) {shapes}; worst forward "
            f"{worst.get('forward')}, backward (dx, doffset, dmask, "
            f"dweight) {worst.get('backward')}")
        for key, tol, unit in (("f32", MESH_DET_TOL, "MESH_DET_TOL"),
                               ("bf16", MESH_BF16_DET["tol"], "bf16 ulps")):
            got, ref = det[layout, key]
            med, top = det_errors(got, ref, tol)
            log(f"  {layout} detect {key}: {int((got[..., 4] >= 0).sum())} "
                f"kept rows (one process {int((ref[..., 4] >= 0).sum())}), "
                f"max |diff| in place {float((got - ref).abs().max()):.3e}, "
                f"row distance to the nearest one-process row ({unit}): "
                f"median {med:.3e}, largest {top:.3e}")
        med, top = det_errors(det[layout, "bf16"][1], det[layout, "f32"][1],
                              MESH_BF16_DET["tol"])
        log(f"  one process's bf16 detect against its float32 detect (bf16 "
            f"ulps): median {med:.3e}, largest {top:.3e}")

    for layout, sp, mp in MESH_LAYOUTS:
        rs = ranks[layout]
        for o in rs:
            check(o["bf16_stats"] == rs[0]["bf16_stats"]
                  and o["f32_stats"] == rs[0]["f32_stats"],
                  f"mesh {layout}: the ranks report other stats")
            check(o["calls"], f"mesh {layout}: no shift-DCN call spied")
            for k in total:
                check(o["launches"][k] > 0, f"mesh {layout} rank "
                      f"{o['rank']}: no {k} launch")
                total[k] += o["launches"][k]
            if mp > 1:
                m = o["memory"]
                check(m["param_bytes"] < mem["param_bytes"]
                      and m["momentum_bytes"] < mem["momentum_bytes"],
                      f"mesh {layout}: a rank holds every parameter")
        hs = {sh[1] for o in rs for _, sh, _ in o["calls"]}
        cs = {sh[4] for o in rs for _, sh, _ in o["calls"]}
        whole = {TRAIN_CROP[0] // f for f in (8, 16, 32)}
        if sp > 1:
            check(all(o["spatial_active"] for o in rs) and not hs & whole,
                  f"mesh {layout}: DCN calls at whole heights {hs}")
        check(cs == {c // mp for c in couts}, f"mesh {layout}: DCN calls "
              f"at Cout {cs}, the layers' are {couts}")
        for key, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            for k, lim in MESH_TOL[dt].items():
                e = errs[layout, key][k]
                check(e <= lim, f"mesh {layout} {key} step against one "
                      f"process: {k} error {e} above {lim}")
        for key, tol, lims in (("f32", MESH_DET_TOL, (1.0, 1.0)),
                               ("bf16", MESH_BF16_DET["tol"],
                                (MESH_BF16_DET["median"],
                                 MESH_BF16_DET["largest"]))):
            got, ref = det[layout, key]
            dists = det_errors(got, ref, tol)
            check(bool(torch.isfinite(got).all())
                  and torch.equal((got[..., 4] >= 0).sum(1),
                                  (ref[..., 4] >= 0).sum(1))
                  and all(e <= lim for e, lim in zip(dists, lims)),
                  f"mesh {layout}: {key} detect against one process: row "
                  f"distances (median, largest) {dists} above {lims}")
    return total


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
    dp_launches = timed(phase_data_parallel, label, train_stats["step_ms"])
    mesh_launches = timed(phase_mesh_axes, label)
    timed(phase_train_card_vs_cpu)
    dt_launches = timed(phase_train_device_targets, label,
                        train_stats["step_ms"])
    life_launches = timed(phase_run_lifecycle, label)
    timed(phase_upstream, label)
    cap_launches = timed(phase_capabilities, label)
    quality_launches = timed(phase_quality_scripts, label)
    bwd = {k: {} for k in BWD_KERNELS}
    for name, n in (("train", train_launches), ("data_parallel",
                                                dp_launches),
                    ("mesh_axes", mesh_launches),
                    ("device_targets", dt_launches),
                    ("lifecycle", life_launches),
                    ("capabilities", cap_launches),
                    ("quality_scripts", quality_launches)):
        fwd[name] = n["forward"]
        for k in BWD_KERNELS:
            bwd[k][name] = n[k]
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
            "launches": sum(bwd[k].values()),
            "max_abs_err": bwd_err[k],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": ("bytes" if t["bytes_ms"] > t["ops_ms"]
                         else "operations"),
            "launches_by_phase": bwd[k],
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
