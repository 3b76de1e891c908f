"""Camera ray generation (perspective + orthographic) with AA jitter.

Parity reference: ``Assets/Shaders/BVHRayTracing.compute:283-340``:

* camera fixed at (0, 0, distance) looking toward -Z; projection plane of
  height ``2 * distance * tan(fov/2)`` at z = 0;
* stratified-jitter AA on a ``ceil(sqrt(n))``-wide grid with Hash22 jitter;
* orthographic variant with half-height ``_OrthoSize``;
* rays transformed camera->object by the inverse camera matrix
  (origin as a point, direction by the 3x3 block, then renormalized).

Pixel convention: ``px`` is the column index (0..W-1), ``py`` the row with
0 at the *bottom* (Unity texture convention; PNG writers flip on save).
"""

from __future__ import annotations

import math
from typing import Tuple

import jax.numpy as jnp

from cosig_tpu.ops import rng
from cosig_tpu.ops.intersect import normalize

F = jnp.float32


def aa_grid(sample_count: int) -> Tuple[int, int]:
    """gridW = ceil(sqrt(n)), gridH = ceil(n / gridW) (compute:285-287)."""
    n = max(1, sample_count)
    grid_w = math.ceil(math.sqrt(n))
    grid_h = math.ceil(n / grid_w)
    return grid_w, grid_h


def sample_offsets(px, py, sample_idx: int, sample_count: int):
    """Sub-pixel offset for AA sample ``sample_idx`` (compute:300-310).

    Single sample -> pixel center (0.5, 0.5); otherwise stratified grid cell
    plus Hash22 jitter keyed on (x + i*13, y + i*7)."""
    if sample_count <= 1:
        half = jnp.full_like(jnp.asarray(px, F), 0.5)
        return half, half
    grid_w, grid_h = aa_grid(sample_count)
    gy, gx = divmod(sample_idx, grid_w)
    jx, jy = rng.hash22(
        jnp.asarray(px, F) + F(sample_idx * 13.0),
        jnp.asarray(py, F) + F(sample_idx * 7.0),
    )
    ox = (F(gx) + jx) / F(grid_w)
    oy = (F(gy) + jy) / F(grid_h)
    return ox, oy


def generate_rays(
    px,
    py,
    ox,
    oy,
    width: int,
    height: int,
    cam_to_obj,  # [4,4]
    cam_distance,  # scalar
    fov_deg,  # scalar
    ortho_size,  # scalar
    is_orthographic: bool,
):
    """Camera-space ray construction + transform to object space.

    Returns (origin [N,3], direction [N,3]) in object space, direction
    normalized (compute:291-340)."""
    px = jnp.asarray(px, F)
    py = jnp.asarray(py, F)
    aspect = F(width) / F(height)

    if is_orthographic:
        # compute:318-327
        half_h = ortho_size
        half_w = half_h * aspect
        u = ((px + ox) / F(width) - F(0.5)) * F(2.0) * half_w
        v = ((py + oy) / F(height) - F(0.5)) * F(2.0) * half_h
        o_cam = jnp.stack([u, v, jnp.broadcast_to(cam_distance, u.shape)], axis=-1)
        d_cam = jnp.broadcast_to(jnp.array([0.0, 0.0, -1.0], F), o_cam.shape)
    else:
        # compute:291-294, 312-313, 329-333
        half_h = cam_distance * jnp.tan(jnp.deg2rad(fov_deg) * F(0.5))
        plane_h = F(2.0) * half_h
        plane_w = plane_h * aspect
        u = ((px + ox) / F(width) - F(0.5)) * plane_w
        v = ((py + oy) / F(height) - F(0.5)) * plane_h
        o_cam = jnp.stack(
            [jnp.zeros_like(u), jnp.zeros_like(u), jnp.broadcast_to(cam_distance, u.shape)],
            axis=-1,
        )
        pixel_pos = jnp.stack([u, v, jnp.zeros_like(u)], axis=-1)
        d_cam = normalize(pixel_pos - o_cam)

    # Ray transform camera -> object space (compute:339-340). Written out
    # component-wise rather than as a matrix product, which a GPU may run
    # in TF32.
    m = cam_to_obj
    ocx, ocy, ocz = o_cam[..., 0], o_cam[..., 1], o_cam[..., 2]
    dcx, dcy, dcz = d_cam[..., 0], d_cam[..., 1], d_cam[..., 2]
    origin = jnp.stack(
        [
            m[0, 0] * ocx + m[0, 1] * ocy + m[0, 2] * ocz + m[0, 3],
            m[1, 0] * ocx + m[1, 1] * ocy + m[1, 2] * ocz + m[1, 3],
            m[2, 0] * ocx + m[2, 1] * ocy + m[2, 2] * ocz + m[2, 3],
        ],
        axis=-1,
    )
    direction = normalize(
        jnp.stack(
            [
                m[0, 0] * dcx + m[0, 1] * dcy + m[0, 2] * dcz,
                m[1, 0] * dcx + m[1, 1] * dcy + m[1, 2] * dcz,
                m[2, 0] * dcx + m[2, 1] * dcy + m[2, 2] * dcz,
            ],
            axis=-1,
        )
    )
    return origin, direction

