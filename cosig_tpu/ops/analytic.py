"""Analytic (non-tessellated) sphere/box geometry mode.

Spec source: the reference's dead CPU oracle path
(``Assets/Services/BVH/HittableObjects.cs``), which the GPU pipeline
replaced with tessellation: transform the ray into each primitive's object
space by the inverse matrix (SphereInstance.Hit :40-75), intersect the
analytic unit sphere (:83-108) / unit box (:182-224), and transform the
normal back by the inverse-transpose.

Pure math, no tree, exact silhouettes: a sphere costs ~30 flops instead
of 768 triangles. The ray
direction is NOT renormalized in object space, so the returned ``t`` is in
world parameterization and compares directly against triangle hits.

Enabled via ``RenderSettings.analytic_primitives``. The contractions pin
``Precision.HIGHEST``: a float32 product left at the default precision
may run in TF32 on a GPU, which keeps only ~3 decimal digits.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from cosig_tpu.models.scene import SceneData
from cosig_tpu.ops import intersect
from cosig_tpu.ops.intersect import INF, Hit
from cosig_tpu.scene import transforms as tf

F = np.float32
HIGHEST = jax.lax.Precision.HIGHEST


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class AnalyticPrims:
    """Sphere/box instance tables (object-space unit primitives).

    ``*_inv`` is the 3x4 inverse (world->object) matrix; ``*_nrm`` the 3x3
    inverse-transpose for normals; ``*_mat`` the material index."""

    sph_inv: jax.Array  # [S, 3, 4]
    sph_nrm: jax.Array  # [S, 3, 3]
    sph_mat: jax.Array  # [S]
    box_inv: jax.Array  # [B, 3, 4]
    box_nrm: jax.Array  # [B, 3, 3]
    box_mat: jax.Array  # [B]

    def tree_flatten(self):
        return (
            (self.sph_inv, self.sph_nrm, self.sph_mat,
             self.box_inv, self.box_nrm, self.box_mat),
            None,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def _instance_tables(scene: SceneData, prims):
    """Host-side (numpy) inverse / inverse-transpose / material tables."""
    if not prims:
        return (
            np.zeros((0, 3, 4), F), np.zeros((0, 3, 3), F),
            np.zeros((0,), np.int32),
        )
    inv = np.stack(
        [tf.inverse(tf.build_matrix(scene, p.transformation_index))[:3, :4] for p in prims]
    ).astype(F)
    nrm = np.stack(
        [tf.normal_matrix(tf.build_matrix(scene, p.transformation_index))[:3, :3] for p in prims]
    ).astype(F)
    mat = np.array([p.material_index for p in prims], np.int32)
    return inv, nrm, mat


def compile_analytic(scene: SceneData) -> AnalyticPrims:
    """Build the instance tables from the parsed scene."""
    s_inv, s_nrm, s_mat = _instance_tables(scene, scene.spheres)
    b_inv, b_nrm, b_mat = _instance_tables(scene, scene.boxes)
    return AnalyticPrims(
        sph_inv=jnp.asarray(s_inv), sph_nrm=jnp.asarray(s_nrm), sph_mat=jnp.asarray(s_mat),
        box_inv=jnp.asarray(b_inv), box_nrm=jnp.asarray(b_nrm), box_mat=jnp.asarray(b_mat),
    )


def _to_object(inv, o, d):
    """Transform rays into each instance's object space.

    inv: [P, 3, 4]; o, d: [N, 3] -> ([N, P, 3], [N, P, 3])."""
    r = inv[:, :, :3]  # [P,3,3]
    t = inv[:, :, 3]  # [P,3]
    o_obj = jnp.einsum("pij,nj->npi", r, o, precision=HIGHEST) + t[None, :, :]
    # NOT normalized (keeps world t).
    d_obj = jnp.einsum("pij,nj->npi", r, d, precision=HIGHEST)
    return o_obj, d_obj


def _closest_over_prims(valid, t):
    """Per-ray argmin over the primitive axis -> (hit, t, idx)."""
    t = jnp.where(valid, t, INF)
    idx = jnp.argmin(t, axis=1)
    rows = jnp.arange(t.shape[0])
    t_best = t[rows, idx]
    return t_best < INF, t_best, idx


def closest_hit_analytic(
    scene_arrays,
    prims: AnalyticPrims,
    o,
    d,
    chunk: int = 256,
) -> Hit:
    """Closest hit over triangles + analytic spheres + analytic boxes."""
    best = intersect.closest_hit_brute(scene_arrays, o, d, chunk)
    n = o.shape[0]

    # ---- spheres (HittableObjects.cs:83-108) ----
    if prims.sph_inv.shape[0] > 0:
        o_obj, d_obj = _to_object(prims.sph_inv, o, d)
        flat = lambda a: a.reshape(-1, 3)
        valid, t, p_obj = intersect.intersect_unit_sphere(flat(o_obj), flat(d_obj))
        P = prims.sph_inv.shape[0]
        valid = valid.reshape(n, P)
        t = t.reshape(n, P)
        hit_s, t_s, idx = _closest_over_prims(valid, t)
        p_sel = p_obj.reshape(n, P, 3)[jnp.arange(n), idx]
        nrm = prims.sph_nrm[idx]  # [N,3,3]
        # Sphere normal = normalized object-space hit position through the
        # inverse-transpose (HittableObjects.cs:63-66).
        n_world = intersect.normalize(
            jnp.einsum("nij,nj->ni", nrm, p_sel, precision=HIGHEST)
        )
        better = hit_s & (t_s < best.t)
        best = Hit(
            hit=best.hit | better,
            t=jnp.where(better, t_s, best.t),
            position=jnp.where(better[:, None], o + t_s[:, None] * d, best.position),
            normal=jnp.where(better[:, None], n_world, best.normal),
            material=jnp.where(better, prims.sph_mat[idx], best.material),
        )

    # ---- boxes (HittableObjects.cs:182-224) ----
    if prims.box_inv.shape[0] > 0:
        o_obj, d_obj = _to_object(prims.box_inv, o, d)
        flat = lambda a: a.reshape(-1, 3)
        valid, t, n_obj = intersect.intersect_unit_box(flat(o_obj), flat(d_obj))
        P = prims.box_inv.shape[0]
        valid = valid.reshape(n, P)
        t = t.reshape(n, P)
        hit_b, t_b, idx = _closest_over_prims(valid, t)
        n_sel = n_obj.reshape(n, P, 3)[jnp.arange(n), idx]
        nrm = prims.box_nrm[idx]
        n_world = intersect.normalize(
            jnp.einsum("nij,nj->ni", nrm, n_sel, precision=HIGHEST)
        )
        better = hit_b & (t_b < best.t)
        best = Hit(
            hit=best.hit | better,
            t=jnp.where(better, t_b, best.t),
            position=jnp.where(better[:, None], o + t_b[:, None] * d, best.position),
            normal=jnp.where(better[:, None], n_world, best.normal),
            material=jnp.where(better, prims.box_mat[idx], best.material),
        )

    return best
