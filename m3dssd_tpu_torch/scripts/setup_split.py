"""Lay out the KITTI split1 train/validation directories, the port's copy
of the reference package's `scripts/setup_split.py`: symlinks of the raw
KITTI `training/` files into `<out>/kitti_split1/{training,validation}`
by the train.txt / val.txt id lists, renumbered from 000000 per split.

    python -m m3dssd_tpu_torch.scripts.setup_split --kitti /path/to/kitti \
        --out ./data --train_ids train.txt --val_ids val.txt
"""

from __future__ import annotations

import argparse
import os


def link_split(kitti_root: str, out_base: str, ids,
               subdirs=("calib", "image_2", "label_2"),
               exts=(".txt", ".png", ".txt")) -> None:
    """Symlink KITTI training files `ids` into `out_base`, numbered in
    order."""
    for sub in subdirs:
        os.makedirs(os.path.join(out_base, sub), exist_ok=True)
    for new_idx, src_id in enumerate(ids):
        for sub, ext in zip(subdirs, exts):
            src = os.path.join(kitti_root, "training", sub, src_id + ext)
            dst = os.path.join(out_base, sub, f"{new_idx:06d}{ext}")
            if os.path.islink(dst) or os.path.exists(dst):
                os.remove(dst)
            os.symlink(os.path.abspath(src), dst)


def read_ids(path: str):
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def setup_split(kitti: str, out: str, train_ids, val_ids) -> str:
    """Both splits under `<out>/kitti_split1`; returns that directory."""
    base = os.path.join(out, "kitti_split1")
    link_split(kitti, os.path.join(base, "training"), train_ids)
    link_split(kitti, os.path.join(base, "validation"), val_ids)
    return base


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m m3dssd_tpu_torch.scripts."
                                     "setup_split")
    p.add_argument("--kitti", required=True, help="raw KITTI object root "
                   "(holds training/ and testing/)")
    p.add_argument("--out", required=True)
    p.add_argument("--train_ids", required=True, help="txt file of train ids")
    p.add_argument("--val_ids", required=True, help="txt file of val ids")
    args = p.parse_args(argv)
    train_ids, val_ids = read_ids(args.train_ids), read_ids(args.val_ids)
    base = setup_split(args.kitti, args.out, train_ids, val_ids)
    print(f"linked {len(train_ids)} training / {len(val_ids)} validation ids "
          f"under {base}")


if __name__ == "__main__":
    main()
