"""KITTI annotation parsing for evaluation.

Re-derivation of ref:lib/eval/kitti_common.py:280-347 (get_label_anno /
get_label_annos): parse KITTI label/result txts into the annotation-dict
format the evaluator consumes. dimensions are stored in lhw (camera) order.
The port's own copy.
"""

from __future__ import annotations

import pathlib
import re
from typing import List, Optional

import numpy as np


def get_label_anno(label_path):
    annotations = {k: [] for k in
                   ["name", "truncated", "occluded", "alpha", "bbox",
                    "dimensions", "location", "rotation_y"]}
    with open(label_path, "r") as f:
        lines = f.readlines()
    content = [line.strip().split(" ") for line in lines if line.strip()]
    annotations["name"] = np.array([x[0] for x in content])
    annotations["truncated"] = np.array([float(x[1]) for x in content])
    annotations["occluded"] = np.array([int(float(x[2])) for x in content])
    annotations["alpha"] = np.array([float(x[3]) for x in content])
    annotations["bbox"] = np.array(
        [[float(v) for v in x[4:8]] for x in content]).reshape(-1, 4)
    # KITTI files store h,w,l; evaluator uses standard camera lhw order
    annotations["dimensions"] = np.array(
        [[float(v) for v in x[8:11]] for x in content]).reshape(-1, 3)[:, [2, 0, 1]]
    annotations["location"] = np.array(
        [[float(v) for v in x[11:14]] for x in content]).reshape(-1, 3)
    annotations["rotation_y"] = np.array(
        [float(x[14]) for x in content]).reshape(-1)
    if len(content) != 0 and len(content[0]) == 16:
        annotations["score"] = np.array([float(x[15]) for x in content])
    else:
        annotations["score"] = np.zeros([len(annotations["bbox"])])
    return annotations


def get_label_annos(label_folder, image_ids: Optional[List] = None):
    if image_ids is None:
        filepaths = pathlib.Path(label_folder).glob("*.txt")
        prog = re.compile(r"^\d{6}.txt$")
        filepaths = filter(lambda f: prog.match(f.name), filepaths)
        image_ids = sorted(int(p.stem) for p in filepaths)
    if not isinstance(image_ids, list):
        image_ids = list(range(image_ids))
    annos = []
    folder = pathlib.Path(label_folder)
    for idx in image_ids:
        annos.append(get_label_anno(folder / f"{idx:06d}.txt"))
    return annos
