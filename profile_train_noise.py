"""How far float32 rounding can move one train step of the flagship.

    python3 profile_train_noise.py [--crop 128x448] [--threads 8]

Takes the train step that `chip_smoke.py` runs on the card and on the CPU
(`phase_train_card_vs_cpu`: the flagship on dla34, batch 2, zero-initialised
DCN offsets, no weight decay, one batch of the in-memory synthetic split)
and runs it on the CPU from the same weights in float64, then again with
one thing changed, and reports how far each parameter's update moved:

- float32 (torch's own BatchNorm, which sums each channel's statistics in
  float32 on the CPU);
- float32 with the BatchNorm statistics and normalisation in float64;
- float64 with the input images scaled by (1 + eps n), n standard normal,
  eps 1e-6 and 1e-9, and with every weight scaled by (1 + eps n), eps 1e-9
  and 1e-12: a smooth step's response shrinks 1000-fold with eps, one
  that crosses a kink or a selection's edge does not.

Per tensor the error is max|update - float64 update| over the tensor's own
largest float64 update (tensors whose update is under 1e-6 of the largest
have a zero gradient and are left out); also given over the largest update
of all. Also prints each BatchNorm input's smallest std/|mean| and smallest
std over its median channel std, the conditioning of the normalisations.
Runs on the CPU; needs no card.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))


def bn_float64_statistics(self, x):
    """Train-mode BatchNorm with its statistics and normalisation in
    float64, cast back to x's dtype (running statistics as the port's)."""
    if not self.training:
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)
    xd = x.double()
    mean = xd.mean((0, 2, 3), keepdim=True)
    var = ((xd - mean) ** 2).mean((0, 2, 3), keepdim=True)
    with torch.no_grad():
        for r, s in ((self.running_mean, mean), (self.running_var, var)):
            r.mul_(0.9).add_(0.1 * s.flatten().to(r.dtype))
    y = (xd - mean) * torch.rsqrt(var + self.eps)
    w = self.weight.double()[None, :, None, None]
    b = self.bias.double()[None, :, None, None]
    return (y * w + b).to(x.dtype)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--crop", default="128x448")
    ap.add_argument("--threads", type=int, default=8)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from m3dssd_tpu_torch.data.loader import TrainLoader
    from m3dssd_tpu_torch.data.synthetic import SyntheticTrainSet
    from m3dssd_tpu_torch.models import build
    from m3dssd_tpu_torch.models.layers import BatchNorm2d
    from m3dssd_tpu_torch.train.state import (create_train_state,
                                              make_train_step)

    torch.set_num_threads(args.threads)
    H, W = (int(v) for v in args.crop.split("x"))
    conf = cs.train_conf((H, W), 2, dtype="float32", backbone="dla34",
                         num_scales=4).replace(warmup=0.0, weight_decay=0.0)
    ds = SyntheticTrainSet(conf, 32, seed=9, imW=W, imH=H, min_h_px=10)
    batch = next(TrainLoader(ds, 2, num_workers=2, seed=1, pack_s2d=True,
                             pin=False).batches(1))
    init = build(conf, device="cpu", seed=0, phase="train").state_dict()
    names = [n for n, _ in build(conf, device="cpu",
                                 phase="train").named_parameters()]
    images = batch["images"]
    noise = torch.randn(images.shape, generator=torch.Generator()
                        .manual_seed(5), dtype=torch.float64)

    def step(dtype, images=images, weight_eps=0.0, bn64=False):
        model = build(conf, device="cpu", seed=0, phase="train").to(dtype)
        if weight_eps:
            g = torch.Generator().manual_seed(3)
            with torch.no_grad():
                for p in model.parameters():
                    p.mul_(1 + weight_eps * torch.randn(
                        p.shape, generator=g, dtype=p.dtype))
        before = {k: v.detach().clone() for k, v in
                  model.state_dict().items()}
        state = create_train_state(conf, model, max_iter=10 ** 6)
        real = BatchNorm2d.forward
        if bn64:
            BatchNorm2d.forward = bn_float64_statistics
        try:
            stats = make_train_step(conf, ds.rois, packed_input=True)(
                state, dict(batch, images=images))
        finally:
            BatchNorm2d.forward = real
        after = {k: v.detach().clone() for k, v in model.state_dict().items()}
        return float(stats["loss"]), before, after

    t0 = time.perf_counter()
    loss64, _, ref = step(torch.float64)
    print(f"dla34 {H}x{W} bs=2, zero DCN offsets, no weight decay: float64 "
          f"loss {loss64:.9f}")
    runs = [("float32", dict(dtype=torch.float32)),
            ("float32, BN in float64", dict(dtype=torch.float32, bn64=True)),
            ("float64, input x (1 + 1e-6 n)", dict(
                dtype=torch.float64,
                images=images.double() * (1 + 1e-6 * noise))),
            ("float64, input x (1 + 1e-9 n)", dict(
                dtype=torch.float64,
                images=images.double() * (1 + 1e-9 * noise))),
            ("float64, weights x (1 + 1e-9 n)", dict(dtype=torch.float64,
                                                     weight_eps=1e-9)),
            ("float64, weights x (1 + 1e-12 n)", dict(dtype=torch.float64,
                                                      weight_eps=1e-12))]
    for label, kw in runs:
        loss, before, after = step(**kw)
        # the step's update from its own start (the perturbed weights'
        # start differs from init) against the float64 step's from init
        upd = {n: after[n].double() - before[n].double() + init[n].double()
               for n in names}
        own, largest = cs.update_errors(upd, init, ref, names)
        vals = np.array(sorted(own.values()))
        worst = max(own, key=own.get)
        print(f"{label}: loss {abs(loss - loss64) / abs(loss64):.3e} "
              f"relative; per-tensor update error over {len(vals)} tensors "
              f"median {np.median(vals):.3e} p90 "
              f"{np.percentile(vals, 90):.3e} max {vals[-1]:.3e} ({worst}); "
              f"over the largest update {largest:.3e}")

    rows = []

    def hook(mod, inp, out):
        x = inp[0].detach()
        mu = x.mean((0, 2, 3))
        sd = x.var((0, 2, 3), unbiased=False).sqrt()
        rows.append((float((sd / mu.abs().clamp(min=1e-30)).min()),
                     float(sd.min() / sd.median()), mod.label))

    model = build(conf, device="cpu", seed=0, phase="train").double()
    for n, mod in model.named_modules():
        if isinstance(mod, BatchNorm2d):
            mod.label = n
            mod.register_forward_hook(hook)
    with torch.no_grad():
        model(images.double(), packed=True)
    r1 = min(rows)
    r2 = min(rows, key=lambda r: r[1])
    print(f"BatchNorm inputs ({len(rows)} layers): smallest std/|mean| "
          f"{r1[0]:.3e} ({r1[2]}); smallest std over the median channel's "
          f"{r2[1]:.3e} ({r2[2]})")
    print(f"took {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
