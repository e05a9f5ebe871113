"""Training CLI, the port's counterpart of the reference package's
`scripts/train.py`.

    python -m m3dssd_tpu_torch.scripts.train --config kitti_3d_base \
        --data_root ./data --output ./output/base --epochs 70

The run directory gets conf.pkl, the source snapshot (model_src/), the
checkpoints (weights/, weights_best/), the eval result txts and, at the
end, a seed checkpoint of the final weights (seed/), from which another
run starts with a fresh optimizer (`conf.pretrained=<run dir>`).

Data-parallel training runs one process per card under torchrun:

    python -m torch.distributed.run --nproc_per_node 4 \
        -m m3dssd_tpu_torch.scripts.train --distributed --config ... \
        --batch_size 8

Each rank takes batch_size / k rows of every global batch; rank 0 writes
the run directory (train/trainer.py). `--mesh_spatial s` and
`--mesh_model m` lay the k ranks out as k / (s m) data ranks, each of s
spatial (image height) x m model (wide output channels) ranks.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m m3dssd_tpu_torch.scripts."
                                     "train")
    p.add_argument("--config", required=True)
    p.add_argument("--data_root", required=True)
    p.add_argument("--output", default="output/run")
    p.add_argument("--cache", default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--restore", type=int, default=None,
                   help="restore from the checkpoint of this step")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--backbone", default=None)
    p.add_argument("--crop", type=int, nargs=2, default=None)
    p.add_argument("--no_pretrain", action="store_true")
    p.add_argument("--timestamp", action="store_true",
                   help="run in a timestamped directory under --output and "
                        "rename it with the best metric at the end")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (plain ops) instead of the card")
    p.add_argument("--distributed", action="store_true",
                   help="data-parallel over the processes torchrun starts: "
                        "python -m torch.distributed.run --nproc_per_node k "
                        "-m m3dssd_tpu_torch.scripts.train --distributed ... "
                        "(NCCL on cards, gloo with --cpu)")
    p.add_argument("--mesh_spatial", type=int, default=None,
                   help="with --distributed: shard each image's height over "
                        "this many ranks (the spatial axis)")
    p.add_argument("--mesh_model", type=int, default=None,
                   help="with --distributed: shard the wide layers' output "
                        "channels over this many ranks (the model axis)")
    return p.parse_args(argv)


def make_conf(config: str, batch_size=None, backbone=None, crop=None,
              no_pretrain: bool = False, mesh_spatial=None, mesh_model=None):
    """The named config with the CLI's overrides."""
    from ..config import load_config

    conf = load_config(config)
    over = {}
    if mesh_spatial:
        over["mesh_spatial"] = mesh_spatial
    if mesh_model:
        over["mesh_model"] = mesh_model
    if batch_size:
        over["batch_size"] = batch_size
    if backbone:
        over["back_bone"] = backbone
    if crop:
        over["crop_size"] = list(crop)
        over["test_scale"] = list(crop)
    if no_pretrain:
        over["pre_train"] = False
    return conf.replace(**over) if over else conf


def run_train(conf, data_root, output: str, cache=None, epochs=None,
              restore=None, timestamp: bool = False, device=None,
              dataset=None, val_dataset=None):
    """Train `conf` into the run directory `output` (see the module
    docstring); `dataset` / `val_dataset` take in-memory splits instead of
    `data_root`'s. Returns the Trainer."""
    from ..train.trainer import Trainer
    from ..utils.checkpoint import restore_checkpoint, save_seed

    trainer = Trainer(conf, data_root, output, cache_folder=cache,
                      timestamped=timestamp, device=device, dataset=dataset,
                      val_dataset=val_dataset)
    if restore is not None:
        restore_checkpoint(os.path.join(output, "weights"), trainer.state,
                           restore)
    trainer.run(epochs)
    if trainer.mesh is None or trainer.mesh.member:
        whole = trainer.whole_model_state()
        if trainer.primary:
            save_seed(trainer.output_dir, trainer.model, state_dict=whole)
    if timestamp:
        trainer.finalize_run_dir()
    return trainer


def main(argv=None):
    args = parse_args(argv)
    if args.distributed:
        from ..parallel.mesh import init_distributed

        init_distributed(device="cpu" if args.cpu else None)
    conf = make_conf(args.config, args.batch_size, args.backbone, args.crop,
                     args.no_pretrain, args.mesh_spatial, args.mesh_model)
    tr = run_train(conf, args.data_root, args.output, cache=args.cache,
                   epochs=args.epochs, restore=args.restore,
                   timestamp=args.timestamp,
                   device="cpu" if args.cpu else None)
    print(f"run directory: {tr.output_dir} ({tr.state.step} steps)")


if __name__ == "__main__":
    main()
