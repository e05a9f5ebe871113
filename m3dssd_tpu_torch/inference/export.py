"""Export of the detector as one self-contained `torch.export` artifact.

The port's counterpart of the reference package's `inference/export.py`.
`export_detector` traces the whole detect graph (forward, decode and NMS)
with `torch.export.export`, the weights held in the program; a serving
process loads it with `load_detector` and calls it without the
model-building code, the config or a checkpoint. The shift-DCN layers of
the neck appear in the graph as calls of the custom op `m3dssd::dcn_shift`
(ops/dcn_op.py) and the NMS as a call of `m3dssd::nms_first_k`
(ops/nms_op.py), so the loading process imports those modules (which
`load_detector` does) and each op runs its hand-written kernel on the card
or its plain version on the CPU. The host syncs of eager detect are graph
operators in the trace (ops/control.py): `torch.cond` for the align and
sparse pre-NMS overflow switches, a `while_loop` for the bitmask NMS
fixpoint.

The exported signature is `(images [B,...], scale_factors [B]) -> dets
[B, top_post, 14]`, or with `batch_size=0` the single-image `(image
[1,...], scale_factor []) -> dets [top_post, 14]`; rows in
`detect.DET_COLS` order, score -1 marking padding. The JSON sidecar has
the reference package's keys; its "platforms" names the export device.
"""

from __future__ import annotations

import copy
import json
import os

import numpy as np
import torch
import torch.nn as nn

from ..utils.device import resolve_device
from .detect import DET_COLS, _Decoder

# sidecar metadata written next to the artifact
_META_SUFFIX = ".json"


class _Detector(nn.Module):
    """forward(images, scale_factors) -> dets: the model, decode and NMS
    of `make_batch_detector` (or, with `single`, `make_detector`)."""

    def __init__(self, conf, rois, model, device, packed_input, single):
        super().__init__()
        self.model = model
        self.dec = _Decoder(conf, rois, device)
        self.packed = packed_input
        self.single = single

    def forward(self, images, scale_factors):
        out = self.model(images, packed=self.packed)
        sfs = scale_factors.to(torch.float32).reshape(-1)
        if self.single:
            out = {k: out[k][:1] for k in ("scores", "cls_pred", "bbox_2d",
                                           "bbox_3d")}
            return self.dec(out, sfs)[0]
        return self.dec(out, sfs)


def _input_specs(conf, batch_size: int, packed_input: bool, device):
    h, w = (int(s) for s in conf.test_scale)
    shape = (h // 2, w // 2, 12) if packed_input else (h, w, 3)
    n = batch_size or 1
    gen = torch.Generator().manual_seed(0)
    img = torch.rand((n,) + shape, generator=gen).to(device)
    sf = torch.ones((n,) if batch_size else (), dtype=torch.float32,
                    device=device)
    return img, sf


def export_detector(conf, rois: np.ndarray, model, *, batch_size: int = 0,
                    packed_input: bool = False, fold_bn: bool = False,
                    master=None, device=None
                    ) -> torch.export.ExportedProgram:
    """Export `(images, scale_factors) -> dets` of an eval-mode `model`
    (from `build`), with its weights in the program.

    Runs on the card unless `device` names another device. `batch_size=0`
    exports the single-image detector ([1, H, W, C] input, scalar scale
    factor), `batch_size=B` the batched one. With `packed_input` the images
    arrive space-to-depth packed ([B, H/2, W/2, 12]); images are float32
    (the program checks it). `fold_bn` folds
    BatchNorm into the preceding convs of a copy of the model first
    (utils/fold_bn.py) and raises when nothing folded; `master`, where
    given, is the state dict at a higher precision that the model was cast
    from (a checkpoint's float32 weights), and the fold reads from it.
    """
    from ..ops import dcn_op, nms_op  # noqa: F401  (register the ops)

    dev = resolve_device(device)
    model = model.to(dev).eval()
    if fold_bn:
        from ..utils.fold_bn import fold_bn_eval

        model = copy.deepcopy(model)
        if fold_bn_eval(model, master) == 0:
            raise ValueError("fold_bn: no conv -> BatchNorm pair folded")
    det = _Detector(conf, rois, model, dev, packed_input,
                    single=not batch_size).eval()
    args = _input_specs(conf, batch_size, packed_input, dev)
    with torch.no_grad():
        return torch.export.export(det, args, strict=False)


def _aval(t) -> str:
    return f"{str(t.dtype).replace('torch.', '')}" \
           f"[{','.join(str(int(d)) for d in t.shape)}]"


def save_exported(ep: torch.export.ExportedProgram, path: str, conf=None,
                  batch_size: int = 0, packed_input: bool = False) -> None:
    """Write the artifact (`torch.export.save`) and a JSON sidecar."""
    torch.export.save(ep, path)
    ins = [n.meta["val"] for n in ep.graph.nodes
           if n.op == "placeholder"
           and n.name in ep.graph_signature.user_inputs]
    outs = [n.meta["val"] for n in ep.graph.nodes if n.op == "output"
            for n in n.args[0]]
    devices = sorted({t.device.type for t in ins})
    meta = {
        "det_cols": DET_COLS,
        "platforms": devices,
        "in_avals": [_aval(t) for t in ins],
        "out_avals": [_aval(t) for t in outs],
        "batch_size": batch_size,
        "packed_input": packed_input,
        "bytes": os.path.getsize(path),
    }
    if conf is not None:
        meta["test_scale"] = [int(s) for s in conf.test_scale]
        meta["score_thres"] = float(getattr(conf, "score_thres", 0.0))
    with open(path + _META_SUFFIX, "w") as f:
        json.dump(meta, f, indent=2)


def load_detector(path: str, device=None):
    """Load an exported detector; returns `detect(images, scale_factors)
    -> dets` (with `.exported`, `.meta` and `.device`). Runs on the card
    unless `device` names another device; a program exported on another
    device is moved there."""
    from ..ops import dcn_op, nms_op  # noqa: F401  (register the ops)

    dev = resolve_device(device)
    ep = torch.export.load(path)
    meta = None
    if os.path.exists(path + _META_SUFFIX):
        with open(path + _META_SUFFIX) as f:
            meta = json.load(f)
    if meta is None or meta.get("platforms") != [dev.type]:
        from torch.export.passes import move_to_device_pass

        ep = move_to_device_pass(ep, dev)
    run = ep.module()

    def detect(images, scale_factors):
        with torch.no_grad():
            return run(torch.as_tensor(images, device=dev),
                       torch.as_tensor(scale_factors, dtype=torch.float32,
                                       device=dev))

    detect.exported = ep
    detect.meta = meta
    detect.device = dev
    return detect
