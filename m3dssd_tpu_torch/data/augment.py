"""The eval image transforms: float conversion, zero padding to the test
size and normalisation (numpy, no OpenCV).

Each transform takes and returns (image HxWxC float32 BGR, imobj), so the
chain composes like the reference package's. The train-phase augmentations
wait for the training slice.
"""

from __future__ import annotations

import numpy as np


class Compose:
    """Chain of transforms; `rng` is passed to each (the eval transforms
    draw nothing from it)."""

    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, img, imobj=None, rng=None):
        for t in self.transforms:
            img, imobj = t(img, imobj, rng=rng)
        return img, imobj


class ConvertToFloat:
    def __call__(self, image, imobj=None, rng=None):
        return image.astype(np.float32), imobj


class Normalize:
    """x/255, subtract the ImageNet mean, divide by its std (per 3-channel
    group)."""

    def __init__(self, mean, stds):
        self.mean = np.array(mean, dtype=np.float32)
        self.stds = np.array(stds, dtype=np.float32)

    def __call__(self, image, imobj=None, rng=None):
        image = image.astype(np.float32) / 255.0
        reps = image.shape[2] // self.mean.shape[0]
        image -= np.tile(self.mean, reps)
        image /= np.tile(self.stds, reps)
        return image, imobj


class Padding:
    """Zero-pad bottom/right to `size` (a larger image is cropped); the
    image keeps its scale, so imobj.scale_factor = 1."""

    def __init__(self, size):
        self.size = size

    def __call__(self, image, imobj=None, rng=None):
        h, w = image.shape[:2]
        padded = np.zeros((self.size[0], self.size[1], image.shape[2]),
                          dtype=image.dtype)
        padded[:min(h, self.size[0]), :min(w, self.size[1])] = \
            image[:self.size[0], :self.size[1]]
        if imobj is not None:
            imobj.scale_factor = 1.0
        return padded, imobj


class Preprocess:
    """Eval pipeline: float, pad to the test size, normalise."""

    def __init__(self, size, mean, stds):
        self.preprocess = Compose([ConvertToFloat(), Padding(size),
                                   Normalize(mean, stds)])

    def __call__(self, img, imobj=None, rng=None):
        return self.preprocess(img, imobj)
