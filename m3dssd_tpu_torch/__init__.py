"""PyTorch/CUDA port of the M3DSSD monocular 3D detector.

A package of its own beside `m3dssd_tpu` (the JAX reference), imported
without it: it uses torch, numpy and the standard library. Entry points run
on the card unless the caller passes `device="cpu"`:

    from m3dssd_tpu_torch.config import flagship_conf
    from m3dssd_tpu_torch.anchors import locate_anchors
    from m3dssd_tpu_torch.models import build
    from m3dssd_tpu_torch.inference.detect import make_batch_detector

    conf = flagship_conf((384, 1280))
    model = build(conf)
    rois = locate_anchors(conf.anchors, conf.feat_size, conf.feat_stride)
    detect = make_batch_detector(conf, rois, model)
    dets = detect(images, scale_factors)      # [B, 40, 14]
"""
