"""Data-free config finalization for smoke runs and benchmarks.

Builds plausible anchors and whitening stats without a dataset, so the model
can be constructed anywhere. Real training derives these from the dataset.
"""

from __future__ import annotations

import numpy as np

from ..anchors import anchor_center


def finalize_conf_synthetic(conf):
    """Attach synthetic anchors ([A,9]) and whitening stats to `conf`."""
    if conf.anchors is not None:
        return conf
    templates = []
    for scale in conf.anchor_scales:
        for ratio in conf.anchor_ratios:
            templates.append(anchor_center(scale * ratio, scale,
                                           conf.feat_stride))
    a2d = np.stack(templates, axis=0)
    A = a2d.shape[0]
    h = a2d[:, 3] - a2d[:, 1]
    # depth prior inversely proportional to pixel height (pinhole geometry)
    z = 720.0 * 1.5 / np.maximum(h, 1.0)
    priors = np.stack([z,
                       np.full(A, 1.6), np.full(A, 1.5), np.full(A, 3.9),
                       np.zeros(A)], axis=1)
    conf.anchors = np.concatenate([a2d, priors], axis=1)
    conf.bbox_means = np.zeros([1, 11])
    conf.bbox_stds = np.concatenate(
        [np.full([1, 4], 0.2), np.full([1, 7], 0.5)], axis=1)
    return conf
