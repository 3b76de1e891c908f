"""BVH structure tests: structural invariants + traversal equivalence
(the BVH walk finds the brute-force closest hit)."""

import numpy as np
import pytest

from cosig_tpu.accel.bvh import build_bvh, validate_bvh
from cosig_tpu.models.scene import (
    BoxDescription,
    CompositeTransformation,
    SceneData,
    SphereDescription,
)
from cosig_tpu.models.soa import compile_scene
from cosig_tpu.scene.parser import load_scene
from cosig_tpu.scene.tessellate import extract_triangles


def _scene_tris():
    s = SceneData(transformations=[CompositeTransformation()])
    s.spheres.append(SphereDescription(0, 0))
    s.boxes.append(BoxDescription(0, 1))
    return s, extract_triangles(s)


def test_bvh_invariants_synthetic():
    _, tris = _scene_tris()
    bvh = build_bvh(tris)
    validate_bvh(bvh, tris)
    assert bvh.num_nodes >= 1
    # Most leaves obey the <=4 threshold; degenerate partitions (identical
    # centroids, e.g. sphere-pole fans) legally exceed it, exactly like the
    # reference's mid==start bail-out (BVHBuilder.cs:142-145).
    leaf_counts = bvh.count[bvh.count > 0]
    assert (leaf_counts <= 4).mean() > 0.9
    assert leaf_counts.max() <= 32
    assert bvh.depth() <= 32  # fits the reference's traversal stack


def test_bvh_invariants_demo_scene(demo_scene_path):
    tris = extract_triangles(load_scene(demo_scene_path))
    bvh = build_bvh(tris)
    validate_bvh(bvh, tris)
    assert tris.count == 788
    assert bvh.triangles.count == 788


def test_bvh_empty():
    from cosig_tpu.scene.tessellate import TriangleSoA

    bvh = build_bvh(TriangleSoA.empty())
    assert bvh.num_nodes == 1
    assert bvh.count[0] == 0


def test_bvh_walk_matches_brute(demo_scene_path):
    """The per-ray BVH stack walk (ops/bvh_traverse.py) must agree with
    the brute-force oracle scan on hits and distances."""
    import jax.numpy as jnp

    from cosig_tpu.models.soa import compile_scene, frame_params, static_config
    from cosig_tpu.ops import bvh_traverse, trace_xla
    from cosig_tpu.ops.intersect import closest_hit_brute
    import cosig_tpu

    scene = load_scene(demo_scene_path)
    tris = extract_triangles(scene)
    arrays = compile_scene(scene, tris)
    bd = bvh_traverse.build_bvh_device(tris)

    # Direct closest-hit agreement on a fan of camera-ish rays.
    rng = np.random.default_rng(0)
    o = np.tile(np.array([[0, 0, 74.0]], np.float32), (256, 1))
    d = rng.normal(size=(256, 3)).astype(np.float32)
    d[:, 2] -= 2.0  # bias toward the scene
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    hb = closest_hit_brute(arrays, jnp.asarray(o), jnp.asarray(d))
    hw = bvh_traverse.closest_hit_bvh(bd, None, jnp.asarray(o), jnp.asarray(d))
    np.testing.assert_array_equal(np.asarray(hw.hit), np.asarray(hb.hit))
    tb, tw = np.asarray(hb.t), np.asarray(hw.t)
    m = np.asarray(hb.hit)
    np.testing.assert_allclose(tw[m], tb[m], rtol=1e-5)
    # Materials agree except possibly on exact-t ties (shared edges).
    assert (np.asarray(hw.material)[m] != np.asarray(hb.material)[m]).mean() < 0.02

    # Full-render agreement at low res.
    st = cosig_tpu.RenderSettings(resolution_override=(48, 32), max_depth=2)
    params = frame_params(scene, st)
    cfg = static_config(scene, st)
    ref = np.asarray(trace_xla.render_jit(arrays, params, cfg))
    img = np.asarray(bvh_traverse.render_jit_bvh(arrays, bd, params, cfg))
    d2 = np.abs(img - ref).max(axis=2)
    assert (d2 > 1e-3).mean() < 0.005
    assert np.sqrt(((img - ref) ** 2).mean()) < 1e-3
