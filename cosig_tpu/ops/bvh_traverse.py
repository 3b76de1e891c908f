"""Accelerated closest-hit for the XLA path: per-ray BVH stack walk.

The reference's ``TraverseBVH`` (``BVHRayTracing.compute:225-267``) is an
iterative traversal with a 32-entry manual stack, a pop-time AABB
early-out (``if (dst >= hit.t) continue;``, compute:245-246) and leaves
scanning ``count <= 4`` triangles. This is its XLA form: a vmapped
``lax.while_loop`` over a fixed-depth stack — every lane executes until
the slowest ray in the batch drains its stack, with finished lanes
masked. O(log T) work per ray instead of the brute-force oracle's O(T),
so the renderer switches the XLA backend to this walk for large scenes;
the brute-force scan (:func:`cosig_tpu.ops.intersect.closest_hit_brute`)
remains the oracle for tests.

Beyond the reference: children are visited near-first (entry-distance
ordered at push time) instead of the reference's blind right-then-left
push, which makes the pop-time best-t early-out fire much earlier.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from cosig_tpu.accel.bvh import build_bvh
from cosig_tpu.ops.intersect import Hit, moller_trumbore, normalize

F = jnp.float32
INF = F(3.402823466e38)

STACK = 48  # >= 2x any sane median-split depth; checked at build time


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class BVHDevice:
    """Flattened BVH + leaf-reordered triangle soup on device.

    Node arrays follow the reference's 32-byte node (BVHBuilder.cs:27-34):
    ``left_or_first`` is the left-child node index for inner nodes
    (count == 0, right child = left + 1) or the first-triangle index for
    leaves (count > 0). Triangle arrays are in leaf order and padded by
    ``max_leaf`` rows of degenerate (all-zero -> never-hit) triangles so
    fixed-width leaf slices stay in bounds."""

    node_min: jax.Array  # [n, 3] f32
    node_max: jax.Array  # [n, 3] f32
    left_or_first: jax.Array  # [n] i32
    count: jax.Array  # [n] i32
    v0: jax.Array  # [Tp, 3] f32
    v1: jax.Array
    v2: jax.Array
    n0: jax.Array
    n1: jax.Array
    n2: jax.Array
    mat: jax.Array  # [Tp] i32
    max_leaf: int

    def tree_flatten(self):
        return (
            (self.node_min, self.node_max, self.left_or_first, self.count,
             self.v0, self.v1, self.v2, self.n0, self.n1, self.n2, self.mat),
            (self.max_leaf,),
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, aux[0])


def _bvh_depth(lof: np.ndarray, cnt: np.ndarray) -> int:
    """Max node depth of the flattened BVH (iterative, host-side)."""
    depth = 0
    stack = [(0, 1)]
    while stack:
        node, d = stack.pop()
        depth = max(depth, d)
        if cnt[node] == 0:
            stack.append((int(lof[node]), d + 1))
            stack.append((int(lof[node]) + 1, d + 1))
    return depth


def build_bvh_device(tris, max_leaf: int = 4) -> BVHDevice:
    """Host-build the reference-spec BVH and upload walk-ready arrays."""
    bvh = build_bvh(tris, max_leaf=max_leaf)
    rt = bvh.triangles
    depth = _bvh_depth(bvh.left_or_first, bvh.count)
    assert depth + 1 <= STACK, f"BVH depth {depth} exceeds stack {STACK}"

    def _pad3(a):
        return jnp.asarray(np.pad(a, ((0, max_leaf), (0, 0))).astype(np.float32))

    return BVHDevice(
        node_min=jnp.asarray(bvh.node_min.astype(np.float32)),
        node_max=jnp.asarray(bvh.node_max.astype(np.float32)),
        left_or_first=jnp.asarray(bvh.left_or_first.astype(np.int32)),
        count=jnp.asarray(bvh.count.astype(np.int32)),
        v0=_pad3(rt.v0), v1=_pad3(rt.v1), v2=_pad3(rt.v2),
        n0=_pad3(rt.n0), n1=_pad3(rt.n1), n2=_pad3(rt.n2),
        mat=jnp.asarray(
            np.pad(rt.material, (0, max_leaf)).astype(np.int32)
        ),
        max_leaf=max_leaf,
    )


def closest_hit_bvh(bd: BVHDevice, scene, o, d) -> Hit:
    """Closest hit of rays [N, 3] via the per-ray BVH walk.

    ``scene`` is unused (geometry lives in ``bd``) but kept so the
    signature matches :func:`intersect.closest_hit_brute` for
    ``trace_xla``'s pluggable closest-hit."""
    del scene
    ml = bd.max_leaf

    def per_ray(o1, d1):
        inv = F(1.0) / d1

        def slab(node):
            """Entry distance to a node's box, INF on miss
            (compute:199-216 semantics).

            Known fp edge (shared with the HLSL reference): a zero
            direction component with the origin exactly ON a node plane
            yields 0 * inf = NaN, all comparisons false, node culled —
            a hit the brute-force oracle would still find. Measure-zero
            for real camera rays; documented rather than clamped so the
            walk stays arithmetic-identical to the reference."""
            t0 = (bd.node_min[node] - o1) * inv
            t1 = (bd.node_max[node] - o1) * inv
            tn = jnp.max(jnp.minimum(t0, t1))
            tf = jnp.min(jnp.maximum(t0, t1))
            return jnp.where((tn > tf) | (tf < F(0.0)), INF, tn)

        def cond(st):
            return st[0] > 0

        def body(st):
            sp, stack, bt, bi, bu, bv = st
            sp = sp - 1
            node = stack[sp]
            # Pop-time ordered early-out: skip subtrees entered no closer
            # than the current best hit (compute:245-246).
            active = slab(node) < bt
            cnt = bd.count[node]
            lof = bd.left_or_first[node]

            # ---- leaf: fixed-width masked scan of its triangles ----
            is_leaf = active & (cnt > 0)
            # dynamic_slice clamps for inner nodes (lof is then a node
            # index); results are masked out by is_leaf.
            tv0 = jax.lax.dynamic_slice(bd.v0, (lof, 0), (ml, 3))
            tv1 = jax.lax.dynamic_slice(bd.v1, (lof, 0), (ml, 3))
            tv2 = jax.lax.dynamic_slice(bd.v2, (lof, 0), (ml, 3))
            _, t, u, v = moller_trumbore(o1[None, :], d1[None, :], tv0, tv1, tv2)
            j = jnp.arange(ml)
            t = jnp.where(is_leaf & (j < cnt), t[0], INF)
            jj = jnp.argmin(t)
            tmin = t[jj]
            better = tmin < bt
            bt = jnp.where(better, tmin, bt)
            bi = jnp.where(better, lof + jj.astype(jnp.int32), bi)
            bu = jnp.where(better, u[0, jj], bu)
            bv = jnp.where(better, v[0, jj], bv)

            # ---- inner: push children, near child on top ----
            is_inner = active & (cnt == 0)
            near = jnp.where(slab(lof) <= slab(lof + 1), lof, lof + 1)
            far = lof + (lof + 1) - near
            sp1 = jnp.minimum(sp + 1, STACK - 1)
            stack = stack.at[sp].set(jnp.where(is_inner, far, stack[sp]))
            stack = stack.at[sp1].set(jnp.where(is_inner, near, stack[sp1]))
            sp = sp + jnp.where(is_inner, 2, 0)
            return sp, stack, bt, bi, bu, bv

        init = (
            jnp.int32(1),
            jnp.zeros((STACK,), jnp.int32),
            INF,
            jnp.int32(-1),
            F(0.0),
            F(0.0),
        )
        _, _, bt, bi, bu, bv = jax.lax.while_loop(cond, body, init)
        return bt, bi, bu, bv

    best_t, best_idx, best_u, best_v = jax.vmap(per_ray)(o, d)

    hit = best_idx >= 0
    safe = jnp.maximum(best_idx, 0)
    w = F(1.0) - best_u - best_v
    normal = normalize(
        w[:, None] * bd.n0[safe] + best_u[:, None] * bd.n1[safe]
        + best_v[:, None] * bd.n2[safe]
    )
    normal = jnp.where(hit[:, None], normal, jnp.array([0.0, 1.0, 0.0], F))
    material = jnp.where(hit, bd.mat[safe], -1)
    position = o + best_t[:, None] * d
    position = jnp.where(hit[:, None], position, jnp.zeros_like(position))
    return Hit(hit=hit, t=best_t, position=position, normal=normal,
               material=material)


@functools.partial(jax.jit, static_argnames=("cfg", "pixel_tile", "with_rays"))
def render_jit_bvh(scene, bvh_dev, params, cfg, pixel_tile: int = 8192,
                   with_rays: bool = False):
    """XLA render with the BVH walk as the closest-hit routine.

    ``with_rays`` returns (image, live-ray count) with the same honest
    counting as the brute-force path (trace_xla.trace_sample)."""
    from cosig_tpu.ops import trace_xla

    ch = functools.partial(closest_hit_bvh, bvh_dev)
    return trace_xla.render_image(
        scene, params, cfg, closest_hit=ch, pixel_tile=pixel_tile,
        with_rays=with_rays,
    )
