"""Faults planted in the program's timed path, for the tests and for
`calibrate.py --fault`: each a context manager that replaces one method of
the port while it is open. A run set up inside it must come out not
correct."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(owner, attr, make):
    real = getattr(owner, attr)
    setattr(owner, attr, make(real))
    try:
        yield
    finally:
        setattr(owner, attr, real)


def altered_answer():
    """The decoder's table with one box edge moved by a pixel."""
    from m3dssd_tpu_torch.inference import detect

    def make(real):
        def forward(self, out, sfs):
            dets = real(self, out, sfs).clone()
            dets[0, 0, 0] += 1.0
            return dets
        return forward

    return _patched(detect._Decoder, "forward", make)


def half_batch():
    """The network's outputs for the second half of the batch replaced by
    the first half's."""
    from m3dssd_tpu_torch.models import rpn

    def make(real):
        def forward(self, images, packed=False):
            out = real(self, images, packed)
            h = images.shape[0] // 2
            for k in ("cls", "scores", "cls_pred", "bbox_2d", "bbox_3d"):
                v = out[k].clone()
                v[h:2 * h] = v[:h]
                out[k] = v
            return out
        return forward

    return _patched(rpn.M3DRPN, "forward", make)


def _nms_threshold(value):
    from m3dssd_tpu_torch.inference import detect

    def make(real):
        def init(self, *args, **kwargs):
            real(self, *args, **kwargs)
            self.nms_thres = value
        return init

    return _patched(detect._Decoder, "__init__", make)


def no_suppression():
    """NMS that suppresses nothing: no IoU lies above 1."""
    return _nms_threshold(1.0)


def wrong_iou():
    """NMS that suppresses above an IoU of 0.5 instead of the
    configuration's 0.4."""
    return _nms_threshold(0.5)


FAULTS = {f.__name__: f for f in (altered_answer, half_batch,
                                  no_suppression, wrong_iou)}
