"""ctypes binding of the native (C++) KITTI eval engine, and the g++ build
of the repository's C++ eval sources.

`build` compiles a source of the repository's `native/` at first use into
`m3dssd_tpu_torch/_build/` (git-ignored), under a name that carries a hash
of the source and the flags; the sources themselves are only read. The
engine is `native/m3deval.cpp`, whose rotated-IoU and matching functions
this module binds. Without g++ or the source, or with M3DSSD_NO_NATIVE
set, `available()` is False and the engine in `kitti_eval.py` runs its
pure-Python path.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from typing import List, Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(os.path.dirname(_PKG), "native")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-fopenmp", "-Wall"]

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_D = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
_I = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")


def build(source: str, flags: List[str], name: str) -> Optional[str]:
    """Path of `native/<source>` compiled by g++ with `flags` into
    `_build/<name>-<hash><ext>` (ext from `name`), building it if needed;
    None when it cannot be built."""
    src = os.path.join(NATIVE_DIR, source)
    cxx = shutil.which("g++")
    if cxx is None or not os.path.exists(src):
        logging.warning("%s not built: %s", source,
                        "no g++" if cxx is None else f"no {src}")
        return None
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode())
    stem, ext = os.path.splitext(name)
    path = os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:12]}{ext}")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    res = subprocess.run([cxx, *flags, "-o", tmp, src],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    if res.returncode != 0:
        logging.warning("%s build failed (exit %d):\n%s", source,
                        res.returncode, res.stdout)
        return None
    os.replace(tmp, path)
    return path


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        if os.environ.get("M3DSSD_NO_NATIVE"):
            return None
        path = build("m3deval.cpp", CXX_FLAGS, "libm3deval.so")
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            logging.warning("native eval load failed: %s", e)
            return None

        lib.rotated_iou.argtypes = [_D, ctypes.c_int64, _D, ctypes.c_int64,
                                    ctypes.c_int, _D]
        lib.rotated_iou.restype = None
        lib.d3_box_overlap.argtypes = [_D, ctypes.c_int64, _D,
                                       ctypes.c_int64, ctypes.c_int, _D]
        lib.d3_box_overlap.restype = None
        lib.compute_statistics.argtypes = [
            _D, _D, ctypes.c_int64, _D, ctypes.c_int64, _I, _I, _D,
            ctypes.c_int64, ctypes.c_int, ctypes.c_double, ctypes.c_double,
            ctypes.c_int, ctypes.c_int, _D, ctypes.c_void_p]
        lib.compute_statistics.restype = ctypes.c_int64
        lib.fused_statistics.argtypes = [
            _D, _D, ctypes.c_int64, _D, ctypes.c_int64, _I, _I, _D,
            ctypes.c_int64, ctypes.c_int, ctypes.c_double, _D,
            ctypes.c_int64, ctypes.c_int, _D]
        lib.fused_statistics.restype = None
        _LIB = lib
        logging.info("native eval engine loaded (%s)", path)
        return _LIB


def available() -> bool:
    return _load() is not None


def _c(a, dtype=np.float64):
    return np.ascontiguousarray(np.asarray(a, dtype=dtype))


def _dc(dc_bboxes):
    return _c(dc_bboxes).reshape(-1, 4) if np.asarray(dc_bboxes).size \
        else np.zeros([0, 4])


def _pairwise(fn, boxes, qboxes, width, criterion):
    boxes = _c(boxes).reshape(-1, width)
    qboxes = _c(qboxes).reshape(-1, width)
    out = np.zeros([boxes.shape[0], qboxes.shape[0]])
    if boxes.size and qboxes.size:
        fn(boxes, boxes.shape[0], qboxes, qboxes.shape[0], criterion, out)
    return out


def rotated_iou(boxes, qboxes, criterion=-1):
    """Pairwise rotated BEV IoU, [N,5] x [K,5] -> [N,K]."""
    return _pairwise(_load().rotated_iou, boxes, qboxes, 5, criterion)


def d3_box_overlap(boxes, qboxes, criterion=-1):
    """Pairwise 3D IoU in camera coordinates, [N,7] x [K,7] -> [N,K]."""
    return _pairwise(_load().d3_box_overlap, boxes, qboxes, 7, criterion)


def compute_statistics(overlaps, gt_datas, dt_datas, ignored_gt, ignored_det,
                       dc_bboxes, metric, min_overlap, thresh=0.0,
                       compute_fp=False, compute_aos=False):
    """Native twin of kitti_eval.compute_statistics (same signature and
    returns)."""
    lib = _load()
    ngt = gt_datas.shape[0]
    ndt = dt_datas.shape[0]
    dc = _dc(dc_bboxes)
    out4 = np.zeros(4)
    th = np.zeros(max(ngt, 1))
    nth = lib.compute_statistics(
        _c(overlaps), _c(gt_datas), ngt, _c(dt_datas), ndt,
        _c(ignored_gt, np.int64), _c(ignored_det, np.int64), dc,
        dc.shape[0], metric, min_overlap, thresh, int(compute_fp),
        int(compute_aos), out4, th.ctypes.data_as(ctypes.c_void_p))
    return (int(out4[0]), int(out4[1]), int(out4[2]), float(out4[3]),
            th[:nth].copy())


def fused_statistics(overlaps, gt_datas, dt_datas, ignored_gt, ignored_det,
                     dc_bboxes, metric, min_overlap, thresholds,
                     compute_aos, pr):
    """Accumulate tp/fp/fn/similarity into pr [nthresh, 4] (float64,
    C-contiguous, written in place) for one image."""
    if pr.dtype != np.float64 or not pr.flags.c_contiguous \
            or pr.shape != (len(thresholds), 4):
        raise ValueError("pr must be a C-contiguous float64 [nthresh, 4]")
    dc = _dc(dc_bboxes)
    _load().fused_statistics(
        _c(overlaps), _c(gt_datas), gt_datas.shape[0], _c(dt_datas),
        dt_datas.shape[0], _c(ignored_gt, np.int64),
        _c(ignored_det, np.int64), dc, dc.shape[0], metric, min_overlap,
        _c(thresholds), len(thresholds), int(compute_aos), pr)
