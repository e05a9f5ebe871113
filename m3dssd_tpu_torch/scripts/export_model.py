"""Export a trained run's detector as a self-contained `torch.export`
artifact, the port's counterpart of the reference package's
`scripts/export_model.py`.

    python -m m3dssd_tpu_torch.scripts.export_model --run_dir output/exp \
        --out det.pt2 --batch_size 8 --packed --fold_bn

The artifact holds forward, decode, NMS and the weights; a serving process
loads it with `m3dssd_tpu_torch.inference.export.load_detector`, with no
config, checkpoint or model code. It is exported on the card unless
`--cpu` is given, and records that device in its JSON sidecar.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m m3dssd_tpu_torch.scripts."
                                     "export_model")
    p.add_argument("--run_dir", required=True, help="training output dir")
    p.add_argument("--out", required=True, help="artifact path (.pt2)")
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=0,
                   help="0 = single-image signature; B = batched")
    p.add_argument("--packed", action="store_true",
                   help="take space-to-depth packed input [B, H/2, W/2, 12] "
                        "(needs conf.stem_s2d)")
    p.add_argument("--fold_bn", action="store_true",
                   help="fold BatchNorm into the preceding convs first, "
                        "from the checkpoint's float32 weights "
                        "(utils/fold_bn.py)")
    p.add_argument("--cpu", action="store_true",
                   help="export on the CPU instead of the card")
    return p.parse_args(argv)


def run_export(run_dir: str, out: str, step=None, batch_size: int = 0,
               packed: bool = False, fold_bn: bool = False, device=None):
    """Export the run's checkpoint of `step` (default the latest) to `out`;
    returns the ExportedProgram."""
    from ..anchors import locate_anchors
    from ..config import Config
    from ..inference.detect import packed_input_eligible
    from ..inference.export import export_detector, save_exported
    from ..models import build
    from ..utils.checkpoint import read_model_weights

    conf = Config.load(os.path.join(run_dir, "conf.pkl"))
    model = build(conf, device=device)
    weights, _ = read_model_weights(os.path.join(run_dir, "weights"), step)
    model.load_state_dict(weights, strict=True)
    use_packed = packed and packed_input_eligible(conf)
    if packed and not use_packed:
        print("warning: --packed ignored (conf.stem_s2d off or odd dims)")
    rois = locate_anchors(conf.anchors, conf.feat_size, conf.feat_stride)
    ep = export_detector(conf, rois, model, batch_size=batch_size,
                         packed_input=use_packed, fold_bn=fold_bn,
                         master=weights, device=device)
    save_exported(ep, out, conf=conf, batch_size=batch_size,
                  packed_input=use_packed)
    return ep


def main(argv=None):
    args = parse_args(argv)
    run_export(args.run_dir, args.out, step=args.step,
               batch_size=args.batch_size, packed=args.packed,
               fold_bn=args.fold_bn, device="cpu" if args.cpu else None)
    print(f"wrote {args.out} ({os.path.getsize(args.out) / 1e6:.1f} MB)")


if __name__ == "__main__":
    main()
