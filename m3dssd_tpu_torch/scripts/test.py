"""Evaluation CLI, the port's counterpart of the reference package's
`scripts/test.py`: a run's conf.pkl and checkpoint through the KITTI test
driver, printing the AP table and the selection metric.

    python -m m3dssd_tpu_torch.scripts.test --run_dir output/exp \
        --data_root ./data [--step N] [--torch_weights ref.pth]

The run's source snapshot (`<run_dir>/model_src`) is preferred, so an old
checkpoint runs with the code that trained it, its CUDA kernels built from
the snapshot's own sources; `--no_src_snapshot` takes the live package.
This module imports nothing of the package at the top, so that the
snapshot can take the package's place before anything of it is loaded.
With `--torch_weights` a checkpoint of the original model is evaluated
(utils/torch_import.py; learned neck offsets pin the gather DCN) and the
results go to `results_parity_<tag>`. The `--mesh_*` flags wait for the
port's parallel slice.
"""

from __future__ import annotations

import argparse
import importlib
import os
import sys

PACKAGE = "m3dssd_tpu_torch"


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m m3dssd_tpu_torch.scripts."
                                     "test")
    p.add_argument("--run_dir", required=True, help="training output dir")
    p.add_argument("--data_root", required=True)
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--phase", default="validation",
                   help="validation | test | train")
    p.add_argument("--torch_weights", default=None,
                   help="checkpoint of the original model (.pth/.pkl) to "
                        "evaluate instead of the run's")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (plain ops) instead of the card")
    p.add_argument("--no_src_snapshot", action="store_true",
                   help="evaluate with the live package, not the run's "
                        "model_src/ snapshot")
    for name in ("--mesh_devices", "--mesh_spatial", "--mesh_model"):
        p.add_argument(name, type=int, default=0 if name.endswith(
            "devices") else 1, help="not ported: must stay at most 1")
    return p.parse_args(argv)


def use_run_source(run_dir: str, snapshot: bool = True):
    """This module as the run's source snapshot has it (the snapshot put
    first on sys.path and every module of the package dropped, so that the
    next import reads the snapshot), or the live one when there is no
    snapshot or `snapshot` is off. The native AP engine's sources stay
    those of the live tree (M3DSSD_NATIVE_DIR)."""
    from ..utils.source_snapshot import snapshot_path

    snap = snapshot_path(run_dir)
    if not snapshot or snap is None:
        return sys.modules[__name__]
    live = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    native = os.path.join(live, "native")
    if os.path.isdir(native):
        os.environ.setdefault("M3DSSD_NATIVE_DIR", native)
    sys.path.insert(0, os.path.abspath(snap))
    for name in [m for m in sys.modules
                 if m == PACKAGE or m.startswith(PACKAGE + ".")]:
        del sys.modules[name]
    return importlib.import_module(f"{PACKAGE}.scripts.test")


def package_dir() -> str:
    """The directory of the package this module belongs to."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_conf(run_dir: str):
    from ..config import Config

    return Config.load(os.path.join(run_dir, "conf.pkl"))


def run_test(run_dir: str, data_root=None, step=None, phase="validation",
             torch_weights=None, device=None, dataset=None, gt_path=None):
    """Evaluate the run's checkpoint of `step` (default the latest), or the
    original-model checkpoint `torch_weights`, on `phase` of `data_root`
    (or the in-memory `dataset` with its labels at `gt_path`). Returns
    (AP dict, selection metric: mean Car 3D AP-R40)."""
    from ..anchors import locate_anchors
    from ..data.kitti import _PHASE_DIR, Kitti3DDataset
    from ..inference.detect import (make_batch_detector, make_detector,
                                    packed_input_eligible)
    from ..inference.test_driver import test_kitti_3d
    from ..models import build
    from ..utils.checkpoint import load_model_weights

    conf = load_conf(run_dir)
    if torch_weights:
        from ..utils.torch_import import (load_reference_checkpoint,
                                          load_torch_file, pin_parity_conf)

        sd = load_torch_file(torch_weights)
        conf = pin_parity_conf(conf, sd)
        model = build(conf, device=device)
        block = "basic" if conf.back_bone == "dla34" else "bottleneck"
        new, _ = load_reference_checkpoint(
            model, sd, num_anchors=conf.anchors.shape[0],
            num_classes=conf.num_classes, block=block)
        model.load_state_dict(new, strict=True)
        tag = os.path.splitext(os.path.basename(torch_weights))[0]
        name = f"results_parity_{tag}"
    else:
        model = build(conf, device=device)
        step = load_model_weights(model, os.path.join(run_dir, "weights"),
                                  step)
        name = f"results_test_{step}"

    if dataset is None:
        dataset = Kitti3DDataset(conf, data_root, phase=phase)
        db = (conf.datasets_train if phase == "train"
              else conf.datasets_validation)[0]
        gt_path = os.path.join(data_root, db["name"],
                               _PHASE_DIR.get(phase, phase), "label_2")
    rois = locate_anchors(conf.anchors, conf.feat_size, conf.feat_stride)
    eval_bs = max(int(getattr(conf, "eval_batch_size", 1)), 1)
    packed = packed_input_eligible(conf)
    if eval_bs > 1:
        detect = make_batch_detector(conf, rois, model, packed_input=packed,
                                     device=device)
    else:
        detect = make_detector(conf, rois, model, packed_input=packed,
                               device=device)
    results = os.path.join(run_dir, "results", name, "data")
    return test_kitti_3d(dataset, detect, conf, results,
                         gt_path=gt_path if gt_path and os.path.isdir(gt_path)
                         else None,
                         batch_size=eval_bs, packed_input=packed)


def main(argv=None):
    args = parse_args(argv)
    if max(args.mesh_devices, args.mesh_spatial, args.mesh_model) > 1:
        raise NotImplementedError("sharded eval (--mesh_*) is not ported")
    mod = use_run_source(args.run_dir, snapshot=not args.no_src_snapshot)
    print(f"{PACKAGE} source: {mod.package_dir()}", flush=True)
    res, sel = mod.run_test(args.run_dir, args.data_root, step=args.step,
                            phase=args.phase,
                            torch_weights=args.torch_weights,
                            device="cpu" if args.cpu else None)
    if res:
        print(res["_text"])
        print("selection metric (mean Car 3D R40):", sel)


if __name__ == "__main__":
    main()
