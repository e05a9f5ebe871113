"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written kernels from `m3dssd_tpu_torch/csrc/`, holds each
against its plain PyTorch version at the shapes the flagship detector gives
it, drives the flagship detector (kitti_3d_anab_fullalign on DLA-102, bf16,
seeded random weights) through `build` and `make_batch_detector` at full
width, checks that every kernel of that path launched, and compares a card
run of the whole detector with a CPU run of the same weights. Any failed
check ends the run with a non-zero exit code.

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
    kernel = re.compile(r"Compiling entry function '\S*(dcn_shift_(?:"
                        r"bf16_wgmma|splitk_reduce|fwd)_kernel)(ILi(\d)E)?")
    for line in report.splitlines():
        m = kernel.search(line)
        if m:
            name = m.group(1) + (f"<R={m.group(3)}>" if m.group(3) else "")
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
    of one 384x1280 image and of a 512x1760 batch of 8, and at odd and
    ragged shapes, in float32 (CUDA-core kernel) and bfloat16 (tensor-core
    kernel). Returns the bf16 sums over each forward's 8 layers:
    {run: {ms, plain_ms, bound_ms, bytes_ms, ops_ms}}, and the largest
    bf16 max|diff|."""
    from m3dssd_tpu_torch.ops import dcn as tdcn
    from m3dssd_tpu_torch.ops import dcn_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sms = dcn_cuda.num_sms(device)
    # (forward it belongs to, (B, H, W, Cin, Cout), clamp, layers it stands for)
    cases = ([("384x1280 bs=1", (1,) + s, 1.0, 1) for s in NECK_SHAPES_384]
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
    lib, report = _build.build()
    log(f"built {os.path.relpath(lib, ROOT)} from "
        f"{os.path.relpath(_build.SOURCE, ROOT)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in ptxas_summary(report):
        log(f"  {line}")
    hgmma = count_sass(lib, "HGMMA")
    if hgmma is not None:
        log(f"  {hgmma} HGMMA (wgmma) instructions in the library's SASS")

    totals, max_err = phase_kernel_vs_plain(torch.device("cuda"))
    launches = phase_detect(label)
    phase_card_vs_cpu()

    # the kernel's numbers summed over one forward of each size: the
    # 384x1280 bs=1 and the 512x1760 bs=8 neck, 8 layers each
    fwd = {k: sum(t[k] for t in totals.values())
           for k in ("ms", "plain_ms", "bound_ms", "bytes_ms", "ops_ms")}
    kernels = [{
        "name": "dcn_v2_shift",
        "route": "cuda",
        "source": "m3dssd_tpu_torch/csrc/dcn_shift.cu",
        "replaces": "m3dssd_tpu/ops/dcn_pallas.py:133",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": fwd["ms"],
        "plain_ms": fwd["plain_ms"],
        "bound_ms": fwd["bound_ms"],
        "bound_by": ("bytes" if fwd["bytes_ms"] > fwd["ops_ms"]
                     else "operations"),
        "library_ms": None,
        "forwards": {run: {k: t[k] for k in ("ms", "plain_ms", "bound_ms")}
                     for run, t in totals.items()},
    }]
    log(f"smoke run took {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
