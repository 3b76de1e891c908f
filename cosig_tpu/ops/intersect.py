"""Ray-primitive intersection (pure jnp; shared by the brute-force scan,
the BVH walk and the analytic mode).

Parity reference:

* Möller-Trumbore: ``Assets/Shaders/BVHRayTracing.compute:153-190``
  (epsilon 1e-4, ``abs(det)`` => no backface culling, closest-hit with
  barycentric smooth-normal interpolation).
* AABB slab test: ``compute:199-216``.
* Analytic unit-sphere / unit-box intersection: the reference's dead CPU
  oracle path ``Assets/Services/BVH/HittableObjects.cs:83-108,182-224`` —
  offered here as a live non-tessellated geometry mode (pure math, no
  tree).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

F = jnp.float32

EPSILON = F(1e-4)  # compute:102
INF = F(3.402823466e38)  # compute:101 (HLSL float max, used as "infinity")


class Hit(NamedTuple):
    """Closest-hit record for a batch of rays (SoA HitRecord, compute:22-29)."""

    hit: jax.Array  # [N] bool
    t: jax.Array  # [N] f32 (INF when miss)
    position: jax.Array  # [N, 3]
    normal: jax.Array  # [N, 3] interpolated, normalized
    material: jax.Array  # [N] i32 (-1 when miss)


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def _cross(a, b):
    return jnp.cross(a, b)


def normalize(v):
    # The squared length is written out, not jnp.sum(v * v, axis=-1): with
    # a reduce, XLA:GPU can turn some normalizations into Triton fusions
    # and others into loop fusions of the same computation, and its kernel
    # deduplication then launches the Triton kernel with the loop fusion's
    # launch dimensions (CUDA_ERROR_INVALID_VALUE; jax 0.9.0, H100).
    sq = v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2]
    return v * (F(1.0) / jnp.sqrt(sq))[..., None]


def reflect(i, n):
    """HLSL reflect: i - 2*dot(i,n)*n."""
    return i - F(2.0) * _dot(i, n)[..., None] * n


def moller_trumbore(o, d, v0, v1, v2):
    """Batched ray-triangle intersection over a (rays x triangles) grid.

    Args: o, d — [N, 3]; v0, v1, v2 — [B, 3] (traced or concrete).
    Returns (valid [N, B], t [N, B], u [N, B], v [N, B]); t is INF where
    invalid.

    Internally the Plücker/edge-volume formulation: for ray (o, d) with
    moment w = o x d, the signed edge volume of edge P->Q is
    V(P,Q) = d . (P x Q) + w . (Q - P) — LINEAR in (d, w). The ray pierces
    the triangle iff V(B,C), V(C,A), V(A,B) share a sign, with barycentrics
    u = V(C,A)/S, v = V(A,B)/S, S = VA+VB+VC = d . n (n = unnormalized
    geometric normal) and t = (n.A - n.o) / S. Same hit test and epsilon
    semantics as the reference's Möller-Trumbore (compute:153-179) at ~55
    flops/pair instead of ~90 (|S| == |MT det|); every closest-hit path
    shares this arithmetic order, so they agree to the ULP."""
    dx, dy, dz = d[:, None, 0], d[:, None, 1], d[:, None, 2]
    ox, oy, oz = o[:, None, 0], o[:, None, 1], o[:, None, 2]
    # Ray moment w = o x d (canonical component order).
    wx = (o[:, 1] * d[:, 2] - o[:, 2] * d[:, 1])[:, None]
    wy = (o[:, 2] * d[:, 0] - o[:, 0] * d[:, 2])[:, None]
    wz = (o[:, 0] * d[:, 1] - o[:, 1] * d[:, 0])[:, None]

    a, b, c = v0, v1, v2

    def cross(p, q):
        return (
            p[:, 1] * q[:, 2] - p[:, 2] * q[:, 1],
            p[:, 2] * q[:, 0] - p[:, 0] * q[:, 2],
            p[:, 0] * q[:, 1] - p[:, 1] * q[:, 0],
        )

    e1 = b - a
    e2 = c - a
    n_x, n_y, n_z = cross(e1, e2)
    n_dot_a = n_x * a[:, 0] + n_y * a[:, 1] + n_z * a[:, 2]
    vad = cross(b, c)
    vbd = cross(c, a)
    vcd = cross(a, b)

    def vol(vd, p, q):
        # V(P,Q) = d . (P x Q) + w . (Q - P)
        return (
            dx * vd[0][None, :] + dy * vd[1][None, :] + dz * vd[2][None, :]
            + wx * (q[:, 0] - p[:, 0])[None, :]
            + wy * (q[:, 1] - p[:, 1])[None, :]
            + wz * (q[:, 2] - p[:, 2])[None, :]
        )

    va = vol(vad, b, c)
    vb = vol(vbd, c, a)
    vc = vol(vcd, a, b)
    s = dx * n_x[None, :] + dy * n_y[None, :] + dz * n_z[None, :]
    n_dot_o = ox * n_x[None, :] + oy * n_y[None, :] + oz * n_z[None, :]
    inv_s = F(1.0) / s
    t = (n_dot_a[None, :] - n_dot_o) * inv_s
    u = vb * inv_s
    v = vc * inv_s
    valid = (
        (jnp.abs(s) >= EPSILON)
        & (va * s >= F(0.0))
        & (vb * s >= F(0.0))
        & (vc * s >= F(0.0))
        & (t > EPSILON)
    )
    t = jnp.where(valid, t, INF)
    return valid, t, u, v


def intersect_aabb(o, d_inv, box_min, box_max):
    """Slab test: distance to entry, or INF when missed (compute:199-216).

    o, d_inv — [..., 3]; box_min/box_max broadcastable to o."""
    t0 = (box_min - o) * d_inv
    t1 = (box_max - o) * d_inv
    tmin = jnp.minimum(t0, t1)
    tmax = jnp.maximum(t0, t1)
    dst_a = jnp.max(tmin, axis=-1)
    dst_b = jnp.min(tmax, axis=-1)
    return jnp.where((dst_a > dst_b) | (dst_b < F(0.0)), INF, dst_a)


# ---------------------------------------------------------------------------
# Brute-force closest hit over the full triangle soup (the oracle path).


def closest_hit_brute(scene, o, d, chunk: int = 256) -> Hit:
    """Closest hit of rays [N,3] against all scene triangles.

    Scans triangle blocks with a running-min carry — the geometry-domain
    blocking analog of blockwise attention (SURVEY.md section 5). Padding
    triangles (all-zero vertices) produce det == 0 and never hit.
    """
    n_rays = o.shape[0]
    T = scene.tri_v0.shape[0]
    if T == 0:
        return _miss(n_rays, o.dtype)

    pad = (-T) % chunk
    def _pad(a):
        if pad == 0:
            return a
        widths = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
        return jnp.pad(a, widths)

    v0 = _pad(scene.tri_v0).reshape(-1, chunk, 3)
    v1 = _pad(scene.tri_v1).reshape(-1, chunk, 3)
    v2 = _pad(scene.tri_v2).reshape(-1, chunk, 3)
    n_blocks = v0.shape[0]
    base_idx = jnp.arange(n_blocks, dtype=jnp.int32) * chunk

    def body(carry, block):
        best_t, best_idx, best_u, best_v = carry
        bv0, bv1, bv2, base = block
        valid, t, u, v = moller_trumbore(o, d, bv0, bv1, bv2)
        # Per-block winner (first-occurrence argmin matches the reference's
        # strict `t < best.t` update order within a block).
        j = jnp.argmin(t, axis=1)
        rows = jnp.arange(t.shape[0])
        t_blk = t[rows, j]
        u_blk = u[rows, j]
        v_blk = v[rows, j]
        idx_blk = base + j.astype(jnp.int32)
        better = t_blk < best_t
        return (
            jnp.where(better, t_blk, best_t),
            jnp.where(better, idx_blk, best_idx),
            jnp.where(better, u_blk, best_u),
            jnp.where(better, v_blk, best_v),
        ), None

    init = (
        jnp.full((n_rays,), INF, F),
        jnp.full((n_rays,), -1, jnp.int32),
        jnp.zeros((n_rays,), F),
        jnp.zeros((n_rays,), F),
    )
    (best_t, best_idx, best_u, best_v), _ = jax.lax.scan(
        body, init, (v0, v1, v2, base_idx)
    )

    hit = best_idx >= 0
    safe_idx = jnp.maximum(best_idx, 0)
    n0 = scene.tri_n0[safe_idx]
    n1 = scene.tri_n1[safe_idx]
    n2 = scene.tri_n2[safe_idx]
    w = F(1.0) - best_u - best_v
    normal = normalize(w[:, None] * n0 + best_u[:, None] * n1 + best_v[:, None] * n2)
    # Default normal (0,1,0) on miss, like TraverseBVH's init (compute:230).
    normal = jnp.where(hit[:, None], normal, jnp.array([0.0, 1.0, 0.0], F))
    material = jnp.where(hit, scene.tri_mat[safe_idx], -1)
    position = o + best_t[:, None] * d
    position = jnp.where(hit[:, None], position, jnp.zeros_like(position))
    return Hit(hit=hit, t=best_t, position=position, normal=normal, material=material)


def _miss(n_rays: int, dtype) -> Hit:
    return Hit(
        hit=jnp.zeros((n_rays,), bool),
        t=jnp.full((n_rays,), INF, F),
        position=jnp.zeros((n_rays, 3), F),
        normal=jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0], F), (n_rays, 3)),
        material=jnp.full((n_rays,), -1, jnp.int32),
    )


# ---------------------------------------------------------------------------
# Analytic primitives (non-tessellated geometry mode).
# Spec source: the reference's dead CPU oracle (HittableObjects.cs).


def intersect_unit_sphere(o, d):
    """Analytic ray vs unit sphere at origin (HittableObjects.cs:83-108).

    o, d — [N,3] in the sphere's object space. Returns (valid, t, normal_obj)
    where normal_obj is the unnormalized object-space normal (= hit point)."""
    a = _dot(d, d)
    b = F(2.0) * _dot(o, d)
    c = _dot(o, o) - F(1.0)
    disc = b * b - F(4.0) * a * c
    sq = jnp.sqrt(jnp.maximum(disc, F(0.0)))
    t0 = (-b - sq) / (F(2.0) * a)
    t1 = (-b + sq) / (F(2.0) * a)
    t = jnp.where(t0 > EPSILON, t0, t1)
    valid = (disc >= F(0.0)) & (t > EPSILON)
    p = o + t[:, None] * d
    return valid, jnp.where(valid, t, INF), p


def intersect_unit_box(o, d):
    """Analytic ray vs axis-aligned unit cube [-0.5, 0.5]^3
    (HittableObjects.cs:182-224). Returns (valid, t, face_normal_obj)."""
    d_inv = F(1.0) / d
    t0 = (F(-0.5) - o) * d_inv
    t1 = (F(0.5) - o) * d_inv
    tmin = jnp.minimum(t0, t1)
    tmax = jnp.maximum(t0, t1)
    t_enter = jnp.max(tmin, axis=-1)
    t_exit = jnp.min(tmax, axis=-1)
    t = jnp.where(t_enter > EPSILON, t_enter, t_exit)
    valid = (t_enter <= t_exit) & (t_exit > EPSILON) & (t > EPSILON)
    p = o + t[..., None] * d
    # Face normal: axis of the largest |coordinate|, sign of that coordinate.
    ap = jnp.abs(p)
    axis = jnp.argmax(ap, axis=-1)
    normal = jax.nn.one_hot(axis, 3, dtype=o.dtype) * jnp.sign(
        jnp.take_along_axis(p, axis[..., None], axis=-1)
    )
    return valid, jnp.where(valid, t, INF), normal
