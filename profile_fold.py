"""BatchNorm folding's rounding on one CUDA card, at the flagship's width.

    python3 profile_fold.py

Builds the flagship (DLA-102, 384x1280 bs=8, packed input) as
`chip_smoke.py`'s lifecycle does at full depth, and for three sets of
weights (a fresh init, the same with every BN's scale, shift and
statistics moved off their init, and 8 steps of the train CLI's
function) runs 8 synthetic validation images through four eval builds:
float32 and bf16, each unfolded and folded from the float32 weights
(`utils/fold_bn.py`). For each output (cls, bbox_2d, bbox_3d) and the backbone's last feature map it
prints |diff| from the float32 unfolded model, relative to that model's
largest magnitude: the median, the 0.99 and 0.999 quantiles, the largest,
and the share above 1e-3. `chip_smoke.py` sets its folding limits
(FOLD_Q, FOLD_TOL, FOLD_BF16_RATIO) from these readings. Prints the
card's name and power limit.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch

KEYS = ("cls", "bbox_2d", "bbox_3d")


def perturb_bn(model, seed):
    """Every BN leaf moved off its init, so that folding does real work."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n, dev = m.num_features, m.weight.device
                m.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, n)))
                m.running_var.copy_(torch.from_numpy(
                    rng.uniform(0.5, 1.5, n)))
                m.bias.add_(torch.from_numpy(rng.normal(0, 0.2, n)).to(dev))
                m.running_mean.add_(torch.from_numpy(
                    rng.normal(0, 0.2, n)).to(dev))
    return model


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_fold: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from m3dssd_tpu_torch.data.synthetic import SyntheticEvalSet
    from m3dssd_tpu_torch.inference import test_driver as drv
    from m3dssd_tpu_torch.models import build
    from m3dssd_tpu_torch.scripts import train as train_cli
    from m3dssd_tpu_torch.utils.checkpoint import read_model_weights
    from m3dssd_tpu_torch.utils.fold_bn import fold_bn_eval

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B = cs.TRAIN_BATCH
    conf = cs.train_conf(cs.TRAIN_CROP, B).replace(
        max_epoch=1, snapshot_epoch=1, eval_epoch=100, display_iter=4,
        warmup=1.0 / 70)
    ds = cs.train_set(conf)         # (sets the anchors and box statistics)
    conf32 = conf.replace(compute_dtype="float32")
    val = SyntheticEvalSet(conf, B, seed=8, imW=cs.TRAIN_IM[1],
                           imH=cs.TRAIN_IM[0])
    pack = drv._packer(conf, packed_input=True, pin=True)
    images = torch.cat([pack(val[i]["input"]) for i in range(B)]).cuda()
    images = images.float()
    print(f"card: {cs.card_label()}")

    def report(weights, tag):
        outs = {}
        for name, c, fold in (("f32", conf32, False),
                              ("f32 folded", conf32, True),
                              ("bf16", conf, False),
                              ("bf16 folded", conf, True)):
            m = build(c)
            m.load_state_dict(weights, strict=True)
            if fold:
                fold_bn_eval(m, weights)
            feats = []
            hook = m.base.register_forward_hook(
                lambda mod, inp, out: feats.append(out))
            with torch.no_grad():
                o = m(images, packed=True)
            hook.remove()
            f = feats[0][-1] if isinstance(feats[0], (list, tuple)) \
                else feats[0]
            outs[name] = {k: o[k].double() for k in KEYS}
            outs[name]["backbone"] = f.double()
            del m
        ref = outs["f32"]
        qs = torch.tensor([0.5, 0.99, 0.999], dtype=torch.float64,
                          device="cuda")
        for name in ("f32 folded", "bf16", "bf16 folded"):
            for k, r in ref.items():
                d = ((outs[name][k] - r).abs() / r.abs().max()).flatten()
                # (torch.quantile takes at most 2^24 elements)
                q = torch.quantile(d[::-(-d.numel() // 2 ** 24)], qs)
                print(f"{tag} {name:11s} {k:8s} q50 {float(q[0]):.3e} "
                      f"q99 {float(q[1]):.3e} q999 {float(q[2]):.3e} "
                      f"max {float(d.max()):.3e} share>1e-3 "
                      f"{float((d > 1e-3).double().mean()):.3e}",
                      flush=True)

    report(build(conf, seed=0, phase="train").state_dict(), "fresh")
    report(perturb_bn(build(conf, seed=0, phase="train"), 3).state_dict(),
           "perturbed BN")
    with tempfile.TemporaryDirectory() as tmp:
        run = os.path.join(tmp, "run")
        train_cli.run_train(conf, None, run, dataset=ds,
                            val_dataset=val)
        weights, _ = read_model_weights(os.path.join(run, "weights"))
        report(weights, "8 steps")
    return 0


if __name__ == "__main__":
    sys.exit(main())
