"""Test-time hill-climbing refinement of depth and yaw by 2D-3D
consistency (numpy, on the host).

Coordinate descent on (z, rotY) with halving steps; the objective is the
negative L1 gap between the detected 2D box and the 2D box re-projected
from the candidate 3D box. The projection is vectorised over all of an
image's detections, so they climb in lockstep, each with its own steps.
"""

from __future__ import annotations

import numpy as np

from .. import geometry as geo


def _objective(p2, p2_inv, box2d_xyxy, cx, cy, z, w3d, h3d, l3d, ry):
    """Objective of every detection: (ol [N], invalid [N]); invalid where a
    corner lies at or behind the camera."""
    c3d = geo.backproject(p2_inv, cx, cy, z)       # [N,4]
    verts, corners = geo.project_3d(p2, c3d[..., 0], c3d[..., 1], c3d[..., 2],
                                    w3d, h3d, l3d, ry, return_3d=True)
    invalid = np.any(corners[..., 2, :] <= 0, axis=-1)
    new_box = geo.bbox_from_verts(verts)           # [N,4]
    ol = -np.abs(new_box - box2d_xyxy).sum(axis=-1)
    return ol, invalid


def hill_climb(p2, p2_inv, box2d_xyxy, cx, cy, z, w3d, h3d, l3d, ry,
               step_z_init=0.0, step_r_init=0.3 * np.pi,
               z_lim=0.0, r_lim=0.01, min_ol_dif=0.0):
    """Vectorized coordinate descent. All args [N] arrays (or scalars).

    Returns refined (z, ry). Per element: propose +/- step; accept the
    better strictly-improving proposal; else halve the step; stop when both
    steps are below their limits.
    """
    cx, cy, z, w3d, h3d, l3d, ry = np.broadcast_arrays(
        *[np.asarray(a, dtype=np.float64) for a in (cx, cy, z, w3d, h3d, l3d, ry)])
    z = z.copy()
    ry = ry.copy()
    N = z.shape[0] if z.ndim else 1

    ol_best, invalid0 = _objective(p2, p2_inv, box2d_xyxy, cx, cy, z,
                                   w3d, h3d, l3d, ry)
    frozen = invalid0.copy()   # invalid initial projections are returned as-is

    step_z = np.full_like(z, float(step_z_init))
    step_r = np.full_like(z, float(step_r_init))

    while np.any((step_z > z_lim) | (step_r > r_lim)):
        live_z = step_z > z_lim
        if live_z.any():
            ol_n, inv_n = _objective(p2, p2_inv, box2d_xyxy, cx, cy,
                                     z - step_z, w3d, h3d, l3d, ry)
            ol_p, inv_p = _objective(p2, p2_inv, box2d_xyxy, cx, cy,
                                     z + step_z, w3d, h3d, l3d, ry)
            take_p = live_z & ~frozen & ((ol_p - ol_best) > min_ol_dif) \
                & (ol_p > ol_n) & ~inv_p
            take_n = live_z & ~frozen & ~take_p \
                & ((ol_n - ol_best) > min_ol_dif) & ~inv_n
            z = np.where(take_p, z + step_z, np.where(take_n, z - step_z, z))
            ol_best = np.where(take_p, ol_p, np.where(take_n, ol_n, ol_best))
            halve = live_z & ~(take_p | take_n)
            step_z = np.where(halve, step_z * 0.5, step_z)

        live_r = step_r > r_lim
        if live_r.any():
            ol_n, inv_n = _objective(p2, p2_inv, box2d_xyxy, cx, cy, z,
                                     w3d, h3d, l3d, ry - step_r)
            ol_p, inv_p = _objective(p2, p2_inv, box2d_xyxy, cx, cy, z,
                                     w3d, h3d, l3d, ry + step_r)
            take_p = live_r & ~frozen & ((ol_p - ol_best) > min_ol_dif) \
                & (ol_p > ol_n) & ~inv_p
            take_n = live_r & ~frozen & ~take_p \
                & ((ol_n - ol_best) > min_ol_dif) & ~inv_n
            ry = np.where(take_p, ry + step_r, np.where(take_n, ry - step_r, ry))
            ol_best = np.where(take_p, ol_p, np.where(take_n, ol_n, ol_best))
            halve = live_r & ~(take_p | take_n)
            step_r = np.where(halve, step_r * 0.5, step_r)

    return z, geo.snap_to_pi(ry)
