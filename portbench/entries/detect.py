"""Entry `detect`: the batched detector of the port,
`make_batch_detector(conf, rois, model, packed_input=True)` ->
`detect(images, scale_factors)`, in a closed loop over a pool of batches.

Set-up builds the program's model with its own `build`, loads the weights
the benchmark made from the seed (`load_state_dict`, strict), packs the
pool's images (space to depth) and calls every batch of the pool once.
A forward hook on the model keeps the network's outputs of a sample of the
window's calls, drawn from the seed (reservoir sampling over all calls);
`check` compares those calls with the reference once the program is freed.
"""

from __future__ import annotations

import random
import time

import numpy as np
import torch

from portbench.reference import decode as rdecode
from portbench.reference.anchors import locate_anchors, synthetic_anchors
from portbench.reference.model import Params, Ref
from portbench.reference.quant import fp8
from portbench.yardstick.roofline import model_counts
from portbench.yardstick.traffic import (CALIBRATION, WEIGHTS, image_pool,
                                         space_to_depth, stream_seed)
from portbench.yardstick.weights import calibrate, make_weights

OUTPUTS = ("cls", "scores", "cls_pred", "bbox_2d", "bbox_3d")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def program_conf(cell):
    """The program's configuration: its named config with the file's
    replacements, anchors synthesised by the program's own helper."""
    from m3dssd_tpu_torch.config import load_config
    from m3dssd_tpu_torch.utils.synthetic_conf import finalize_conf_synthetic

    prog = cell.config["program"]
    return finalize_conf_synthetic(load_config(prog["config"],
                                               **prog["replace"]))


class Entry:
    """One cell's detector, set up and warmed."""

    unit = "images"

    def __init__(self, cell, seed: int, device, log=print):
        from m3dssd_tpu_torch.anchors import locate_anchors as prog_rois
        from m3dssd_tpu_torch.inference.detect import make_batch_detector
        from m3dssd_tpu_torch.models import build

        self.cell = cell
        t0 = time.perf_counter()
        stamp = lambda what: log(f"set-up: {what} at "
                                 f"{time.perf_counter() - t0:.2f} s")
        self.cfg = cell.config["model"]
        self.traffic = t = cell.traffic
        self.anchors, self.means, self.stds = synthetic_anchors(self.cfg)
        # the reference's own seconds (counts, calibration), which set-up
        # leaves out
        t1 = time.perf_counter()
        spec, dcn_shapes, flops, _ = model_counts(self.cfg, self.anchors,
                                                  self.means, self.stds)
        self.flops_per_unit = float(sum(flops.values()))
        self.yardstick_s = time.perf_counter() - t1
        stamp("counts")
        self.dcn_shapes = [(t["batch"],) + s[1:] for s in dcn_shapes]
        self.dtype = DTYPES[self.cfg["compute_dtype"]]
        self.weights = make_weights(spec, stream_seed(seed, WEIGHTS), device,
                                    self.dtype)
        stamp("weights drawn")
        t1 = time.perf_counter()
        calibrate(self.weights, self.cfg, self.anchors, self.means,
                  self.stds, stream_seed(seed, CALIBRATION),
                  (t["height"], t["width"]), int(t["calibration_images"]),
                  *(float(t[k]) for k in (
                      "scale_factor", "offset_std", "delta_std",
                      "anchor_iou_power", "logit_std", "car_lead",
                      "detections_per_image")))
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        self.yardstick_s += time.perf_counter() - t1
        stamp("weights calibrated")
        conf = program_conf(cell)
        self.model = build(conf, device=device)
        stamp("program build")
        self.model.load_state_dict(self.weights, strict=True)
        rois = prog_rois(conf.anchors, conf.feat_size, conf.feat_stride)
        self.detect = make_batch_detector(conf, rois, self.model,
                                          packed_input=True, device=device)
        self.images, self.sf = image_pool(t, seed, device)
        self.packed = [space_to_depth(x).contiguous() for x in self.images]
        self.kept = []                  # [(batch, outputs, dets)]
        self.rng = random.Random(seed)
        self.sample = int(t["check_calls"])
        self._last = None
        self._hook = self.model.register_forward_hook(self._keep)
        stamp("inputs")
        for i in range(len(self.packed) * int(t["warmup_rounds"])):
            self.call(-1 - i)
        self.kept = []
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        stamp("warm-up")

    def _keep(self, mod, args, out):
        self._last = {k: out[k] for k in OUTPUTS}

    def call(self, i: int):
        """Issue call i (batch i mod pool); returns the number of units."""
        b = i % len(self.packed)
        dets = self.detect(self.packed[b], self.sf)
        item = (b, self._last, dets)
        self._last = None
        if len(self.kept) < self.sample:
            self.kept.append(item)
        else:
            j = self.rng.randrange(i + 1) if i >= 0 else self.sample
            if j < self.sample:
                self.kept[j] = item
        return int(self.packed[b].shape[0])

    def close(self):
        """Free the program's state; keep the sample, inputs, weights."""
        self._hook.remove()
        del self.detect, self.model
        self.packed = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    # -- correctness ------------------------------------------------------
    def reference(self, images, quant=None):
        """The reference's outputs for images [B,H,W,3], float32, in blocks
        of `ref_block` images."""
        params = Params({k: v.float() for k, v in self.weights.items()})
        ref = Ref(self.cfg, params, quant=quant, anchors=self.anchors,
                  means=self.means, stds=self.stds)
        blk = int(self.traffic["ref_block"])
        outs = [ref.forward(images[i:i + blk].float())
                for i in range(0, images.shape[0], blk)]
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}

    def reference_dets(self, out, quant=None, judged=None):
        """The reference's decode and NMS of network outputs `out`; with
        `judged`, a side's tables [B, K, 14] of the same outputs, the NMS
        follows them where an IoU lies within its margin of nms_thres
        (reference/decode.py)."""
        q = quant or (lambda t: t)
        dev = out["scores"].device
        f = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                      device=dev)
        rois = f(locate_anchors(self.anchors, self.cfg))
        anchors, means, stds = f(self.anchors), f(self.means), f(self.stds)
        sf = self.sf.float()
        return torch.stack([rdecode.detections(
            self.cfg, rois, anchors, means, stds, out["scores"][b].float(),
            out["cls_pred"][b], q(out["bbox_2d"][b].float()),
            q(out["bbox_3d"][b].float()), float(sf[b]),
            None if judged is None else judged[b])
            for b in range(out["scores"].shape[0])])

    def compare(self, got, dets, want, rdets):
        """The compared numbers of one call: `got` the side's outputs and
        `dets` its table, `want` the reference's outputs and `rdets` the
        reference's decode and NMS of `got`."""
        def rel(k):
            return float((got[k].float() - want[k]).norm()
                         / want[k].norm().clamp(min=1e-30))

        logits = want["cls"][..., 1:]                        # [B, N, C-1]
        best = logits.max(-1).values
        chosen = logits.gather(-1, (got["cls_pred"].long() - 1).clamp(
            0, logits.shape[-1] - 1)[..., None])[..., 0]
        scale = logits.std().clamp(min=1e-30)
        cls_gap = float((best - chosen).max() / scale)
        dets = dets.float()
        dets_err = float(((dets - rdets).abs() / rdets.abs().clamp(min=1.0))
                         .max())
        if not torch.equal(dets[..., 4] >= 0, rdets[..., 4] >= 0):
            dets_err = max(dets_err, 1.0)
        return {"cls_err": rel("cls"), "score_err": rel("scores"),
                "box_err": max(rel("bbox_2d"), rel("bbox_3d")),
                "cls_gap": cls_gap, "dets_err": dets_err}

    def readings(self, control: bool = False):
        """{number: worst over the sampled calls} of the program, or with
        `control` of the reference in fp8 put in the program's place, plus
        diagnostics."""
        worst, diag = {}, {"confident_positions": 0, "candidates": 0,
                           "detections": 0, "images_nms_suppressed": 0,
                           "images": 0}
        thresh = float(self.cfg["score_thres"])
        rows = int(self.cfg["nms_topN_post"])
        with torch.no_grad():
            for b, got, dets in self.kept:
                want = self.reference(self.images[b])
                if control:
                    got = self.reference(self.images[b], quant=fp8)
                    dets = self.reference_dets(got, quant=fp8)
                rdets = self.reference_dets(got, judged=dets)
                for k, v in self.compare(got, dets, want, rdets).items():
                    worst[k] = max(worst.get(k, 0.0), v)
                    if v != v:                                 # NaN
                        worst[k] = float("inf")
                prob = torch.softmax(want["cls"], -1)
                conf = (1.0 - prob[..., 0]).reshape(
                    dets.shape[0], -1, len(self.anchors)).amax(-1)
                per_image = (conf > float(self.cfg["align_thresh"])).sum(-1)
                diag["confident_positions"] += int(per_image.sum())
                cand = (got["scores"].float() >= thresh).sum(-1)
                diag["candidates"] += int(cand.sum())
                diag["detections"] += int((dets[..., 4] >= 0).sum())
                # images in which the reference's NMS suppressed a candidate
                kept = (rdets[..., 4] >= 0).sum(-1)
                diag["images_nms_suppressed"] += int(
                    (kept < cand.clamp(max=rows)).sum())
                diag["most_confident_in_an_image"] = max(
                    diag.get("most_confident_in_an_image", 0),
                    int(per_image.max()))
                diag["images"] += int(dets.shape[0])
        return worst, diag

    def check(self):
        """[(number, value, limit)] over the sampled calls (limit None
        where the cell has none yet), and diagnostics."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        worst, diag = self.readings()
        limits = self.cell.limits
        return [(k, v, float(limits[k]["limit"]) if k in limits else None)
                for k, v in worst.items()], diag
