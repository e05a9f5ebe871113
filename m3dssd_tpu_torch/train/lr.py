"""Learning-rate policies: cos / poly / step with linear warmup.

The port's copy of the reference package's `train/lr.py`, as a plain
`step -> lr` function. `step` is the optimizer's update count before the
update it prices (0 for the first), as optax passes it.
"""

from __future__ import annotations

import math

import numpy as np


def make_lr_schedule(conf, max_iter: int):
    """`f(step) -> lr` for conf.lr_policy (cos | poly | step); `max_iter` is
    the total number of optimizer iterations."""
    lr0 = float(conf.lr)
    lr_target = float(conf.lr_target)
    policy = conf.lr_policy.lower()
    if policy not in ("cos", "poly", "step"):
        raise ValueError(f"{policy} lr_policy not understood")
    warmup_iters = int(max_iter * conf.warmup)
    steps = ((np.asarray(conf.lr_steps, np.float64) * max_iter)
             .astype(np.float32) if conf.lr_steps else None)
    total_steps = len(conf.lr_steps) if conf.lr_steps else max_iter
    f32 = np.float32

    def sched(it) -> float:
        it = f32(it)
        if steps is not None:
            step_count = f32(np.sum((steps - it) <= 0))
        else:
            step_count = it
        if policy == "step":
            scale = (lr_target / lr0) ** (1.0 / total_steps)
            return float(f32(lr0 * f32(scale) ** step_count))
        if policy == "poly":
            power = 0.9
            if step_count < warmup_iters:
                denom = max(total_steps * conf.warmup, 1.0)
                return float(f32(step_count / f32(denom) * f32(lr0)))
            scale = total_steps / (1 - (lr_target / lr0) ** (1 / power))
            return float(f32(lr0) * f32(max(1 - step_count / f32(scale),
                                             0.0)) ** f32(power))
        if step_count < warmup_iters:
            return float(f32(step_count / f32(max(warmup_iters, 1)) * lr0))
        sc = f32((step_count - warmup_iters) / f32(max(max_iter - warmup_iters,
                                                       1)))
        half = f32(0.5 * (lr0 - lr_target))
        return float(f32(lr_target) + half * (f32(1.0) + np.cos(
            sc * f32(math.pi))))

    return sched
