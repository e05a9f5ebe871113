"""KITTI test driver: detect over an eval split, write KITTI result txts,
and evaluate AP11 / AP-R40.

Per image: detect -> score threshold -> alpha -> rotY on the back-projected
ray -> hill-climb refinement of depth and yaw -> bottom-center restore ->
one KITTI result line per detection. Images are read and packed on
prefetch threads, uploaded from pinned memory, and detected a batch at a
time; the main thread then post-processes and writes each batch.

Over a data axis of W processes (`parallel.make_mesh`) rank r detects and
post-processes batches k = r, r + W, ... of the single-process loop (the
same batches, so the same launch plans), sends its rows to rank 0, and
rank 0 alone writes the txts and computes AP.
"""

from __future__ import annotations

import logging
import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from .. import geometry as geo
from ..parallel.mesh import broadcast_one_to_all, gather_to_primary
from .hill_climb import hill_climb


def write_kitti_result(path, dets_rows):
    """dets_rows: list of dicts with KITTI fields."""
    lines = []
    for r in dets_rows:
        lines.append(
            ("{cls} -1 -1 {alpha:.6f} {x1:.6f} {y1:.6f} {x2:.6f} {y2:.6f} "
             "{h3d:.6f} {w3d:.6f} {l3d:.6f} {x3d:.6f} {y3d:.6f} {z3d:.6f} "
             "{ry3d:.6f} {score:.6f}").format(**r))
    with open(path, "w") as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))


def postprocess_dets(conf, dets: np.ndarray, p2: np.ndarray,
                     p2_inv: np.ndarray):
    """Host post-processing of one image's detection table [K, 14]
    (columns per inference.detect.DET_COLS), in float64. Returns KITTI
    result rows."""
    dets = np.asarray(dets, dtype=np.float64)
    dets = dets[dets[:, 4] >= conf.score_thres]
    if dets.shape[0] == 0:
        return []

    x1, y1, x2, y2 = dets[:, 0], dets[:, 1], dets[:, 2], dets[:, 3]
    score, cls_ind = dets[:, 4], dets[:, 5].astype(int)
    x3d_2d, y3d_2d, z3d = dets[:, 6], dets[:, 7], dets[:, 8]
    w3d, h3d, l3d, alpha_dec = dets[:, 9], dets[:, 10], dets[:, 11], dets[:, 12]

    # the decoded rotation is alpha; rotY is alpha on the back-projected ray
    coord3d = geo.backproject(p2_inv, x3d_2d, y3d_2d, z3d)
    ry3d = geo.convert_alpha_to_rot(alpha_dec, coord3d[:, 2], coord3d[:, 0])

    if conf.hill_climbing:
        box2d_xyxy = np.stack([x1, y1, x2, y2], axis=1)
        z3d, ry3d = hill_climb(p2, p2_inv, box2d_xyxy, x3d_2d, y3d_2d, z3d,
                               w3d, h3d, l3d, ry3d,
                               step_r_init=0.3 * np.pi, r_lim=0.01)

    # final back-projection; KITTI's y is the bottom face of the box
    coord3d = geo.backproject(p2_inv, x3d_2d, y3d_2d, z3d)
    alpha = geo.convert_rot_to_alpha(ry3d, coord3d[:, 2], coord3d[:, 0])
    x3d = coord3d[:, 0]
    y3d = coord3d[:, 1] + h3d / 2
    z3d_out = coord3d[:, 2]

    rows = []
    for i in range(dets.shape[0]):
        rows.append(dict(
            cls=conf.lbls[cls_ind[i] - 1], alpha=alpha[i],
            x1=x1[i], y1=y1[i], x2=x2[i], y2=y2[i],
            h3d=h3d[i], w3d=w3d[i], l3d=l3d[i],
            x3d=x3d[i], y3d=y3d[i], z3d=z3d_out[i],
            ry3d=ry3d[i], score=score[i]))
    return rows


def _packer(conf, packed_input: bool, pin: bool):
    """The per-image host transform: [H, W, 3] float32 numpy ->
    [1, H, W, 3] (or space-to-depth [1, H/2, W/2, 12]) tensor, in bf16
    for a bf16 model (it casts its input to bf16 anyway, so the upload
    halves at no change in output), in pinned memory for a card."""
    from ..models.dla import space_to_depth

    bf16 = getattr(conf, "compute_dtype", "float32") == "bfloat16"

    def pack(im):
        t = torch.from_numpy(im)[None]
        if bf16:
            t = t.to(torch.bfloat16)
        if packed_input:
            t = space_to_depth(t)
        return t.pin_memory() if pin else t.contiguous()

    return pack


def txt_writer(results_path: str):
    """`emit(image_id, rows)` writing the image's KITTI result txt into
    `results_path`."""
    def emit(image_id, dets_rows):
        write_kitti_result(os.path.join(results_path, image_id + ".txt"),
                           dets_rows)
    return emit


def _run_batched(dataset, detect, conf, emit, batch_size: int, pack,
                 device: torch.device, prefetch_workers: int = 8,
                 rank: int = 0, size: int = 1):
    """The eval loop over batches rank, rank + size, ... of `batch_size`
    images. Prefetch threads read and pack images; the main thread uploads
    each batch (tail padded by repeating its last image; the padding's
    rows are dropped), detects, brings the [B, K, 14] table to the host,
    post-processes it and passes each image's rows to `emit(id, rows)`.

    The post-process stays on the main thread: on the H100 a worker thread
    that post-processes batch k while batch k+1 is detected measured slower
    (PERF.md), since both hold the interpreter lock."""
    n = len(dataset)
    B = max(int(batch_size), 1)
    starts = range(rank * B, n, size * B)
    order = [i for s in starts for i in range(s, min(s + B, n))]

    def load(i):
        s = dataset[i]
        return pack(s["input"]), float(s["meta"]["scale_factor"]), s["meta"]

    with ThreadPoolExecutor(max_workers=prefetch_workers) as pool:
        # at most ~2 batches of loaded images in flight
        window = max(2 * B, prefetch_workers + 1)
        futures = deque(pool.submit(load, i) for i in order[:window])
        next_i = len(futures)
        for start in starts:
            ims, sfs, metas = [], [], []
            for _ in range(min(B, n - start)):
                im, sf, meta = futures.popleft().result()
                if next_i < len(order):
                    futures.append(pool.submit(load, order[next_i]))
                    next_i += 1
                ims.append(im)
                sfs.append(sf)
                metas.append(meta)
            imb = torch.empty((B,) + tuple(ims[0].shape[1:]),
                              dtype=ims[0].dtype, device=device)
            for j in range(B):
                imb[j:j + 1].copy_(ims[min(j, len(ims) - 1)],
                                   non_blocking=True)
            sfs += sfs[-1:] * (B - len(sfs))
            sfb = torch.tensor(sfs, dtype=torch.float32).to(device)
            dets = detect(imb, sfb)
            arr = dets.reshape(B, -1, dets.shape[-1]).cpu().numpy()
            for j, meta in enumerate(metas):
                emit(meta["id"], postprocess_dets(conf, arr[j], meta["p2"],
                                                  np.linalg.inv(meta["p2"])))


def test_kitti_3d(dataset, detect, conf, results_path: str,
                  gt_path: Optional[str] = None, evaluate: bool = True,
                  batch_size: int = 1, packed_input: bool = False,
                  mesh=None):
    """Run `detect` over `dataset` (an eval split: `dataset[i]` ->
    {"input", "meta"}), write one KITTI result txt per image into
    `results_path`, and with `evaluate` and `gt_path` compute AP against
    the gt label txts there.

    `detect` is a port detector (`inference.detect.make_batch_detector`,
    or `make_detector` for batch_size 1); it runs on its own device
    (`detect.device`, the CPU when it has none). `packed_input`: the
    detector was built with packed_input=True, so images go up
    space-to-depth packed. A bf16 model gets bf16 images.

    `mesh`: a mesh (`parallel.make_mesh`) every rank of which calls this
    with the same split and its own detector (of a model built on the
    mesh). Data rank d runs batches d, d + W, ... (with every spatial and
    model rank of its data coordinate, whose detections are the same);
    rank 0 gathers the rows of spatial and model rank 0 of every data
    rank (as host objects),
    writes the txts and computes AP, and then broadcasts the selection
    metric, so every rank returns the same one (and takes the same
    best-model branch in the Trainer); the results dict stays None off
    rank 0.

    Returns (results dict or None, mean Car 3D AP-R40).
    """
    primary = mesh is None or mesh.primary
    if primary:
        os.makedirs(results_path, exist_ok=True)
    device = torch.device(getattr(detect, "device", "cpu"))
    pack = _packer(conf, packed_input, pin=device.type == "cuda")
    write = txt_writer(results_path)
    t0 = time.time()
    if mesh is None:
        _run_batched(dataset, detect, conf, write, batch_size, pack, device)
    else:
        rows = {}
        _run_batched(dataset, detect, conf, rows.__setitem__, batch_size,
                     pack, device, rank=mesh.rank, size=mesh.size)
        # spatial and model rank 0 of each data rank holds the rows the
        # others computed with it
        parts = gather_to_primary(rows, mesh) \
            if mesh.s == 0 and mesh.m == 0 else None
        for part in parts or ():
            for image_id, dets_rows in part.items():
                write(image_id, dets_rows)
    dt = time.time() - t0
    n = len(dataset)
    logging.info("test_kitti_3d: %d images in %.1fs (%.2f im/s)", n, dt,
                 n / max(dt, 1e-9))

    res, sel = None, 0.0
    if primary and evaluate and gt_path:
        from ..eval.kitti_eval import evaluate_kitti
        res = evaluate_kitti(gt_path, results_path, classes=conf.lbls)
        sel = float(np.mean(res.get("Car_3d_R40", [0.0, 0.0, 0.0])))
    return res, broadcast_one_to_all(sel, mesh)
