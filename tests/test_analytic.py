"""Analytic sphere/box mode tests (ops/analytic.py; spec source:
HittableObjects.cs, the reference's dead CPU oracle path)."""

import numpy as np
import jax.numpy as jnp
import pytest

import cosig_tpu
from cosig_tpu.models.scene import (
    BoxDescription,
    CameraSettings,
    CompositeTransformation,
    ImageSettings,
    LightSource,
    MaterialDescription,
    SceneData,
    SphereDescription,
    TransformElement,
)
from cosig_tpu.ops import intersect
from cosig_tpu.render.renderer import Renderer


def test_unit_sphere_intersection_exact():
    o = jnp.asarray([[0.0, 0.0, 5.0], [3.0, 0.0, 5.0], [0.0, 0.0, 0.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0], [0.0, 0.0, -1.0]], jnp.float32)
    valid, t, p = intersect.intersect_unit_sphere(o, d)
    v, tt = np.asarray(valid), np.asarray(t)
    assert v[0] and tt[0] == pytest.approx(4.0, abs=1e-5)  # front hit
    assert not v[1]  # miss (offset 3 > radius)
    assert v[2] and tt[2] == pytest.approx(1.0, abs=1e-5)  # inside -> back face


def test_unit_box_intersection_exact():
    o = jnp.asarray([[0.0, 0.0, 5.0], [0.7, 0.0, 5.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]], jnp.float32)
    valid, t, n = intersect.intersect_unit_box(o, d)
    v, tt, nn = np.asarray(valid), np.asarray(t), np.asarray(n)
    assert v[0] and tt[0] == pytest.approx(4.5, abs=1e-5)
    np.testing.assert_allclose(nn[0], (0, 0, 1), atol=1e-6)  # +z face
    assert not v[1]  # x = 0.7 > 0.5


def _sphere_scene():
    s = SceneData(
        image=ImageSettings(48, 48, (0.0, 0.0, 0.0)),
        transformations=[
            CompositeTransformation(),
            CompositeTransformation([TransformElement.translation((0, 0, 40))]),
            CompositeTransformation(
                [TransformElement.translation((0, 0, 0)), TransformElement.scale((3, 3, 3))]
            ),
        ],
        camera=CameraSettings(0, 12.0, 60.0),
        lights=[LightSource(1, (1, 1, 1))],
        materials=[MaterialDescription((0.8, 0.4, 0.2), 0.1, 0.7, 0, 0, 1)],
        spheres=[SphereDescription(2, 0)],
    )
    return s


def test_analytic_close_to_tessellated():
    s = _sphere_scene()
    r = Renderer(backend="xla")
    st = cosig_tpu.RenderSettings(max_depth=1)
    img_t = r.render(s, st)
    img_a = r.render(s, st.replace(analytic_primitives=True))
    # Interiors match closely; silhouettes differ by the 768-triangle
    # tessellation error (the analytic disc is slightly larger).
    center = (slice(18, 30), slice(18, 30))
    np.testing.assert_allclose(img_a[center], img_t[center], atol=0.02)
    # Both images show the sphere (non-background content).
    assert img_a.max() > 0.3 and img_t.max() > 0.3


def test_analytic_box_mode():
    s = _sphere_scene()
    s.spheres = []
    s.boxes = [BoxDescription(2, 0)]
    r = Renderer(backend="xla")
    # Geometry (depth map) must match the tessellated cube exactly away
    # from silhouette edges. Shading is intentionally different: analytic
    # boxes return outward face normals (HittableObjects.cs:182-224) while
    # the tessellated cube preserves the reference's inconsistent winding
    # (inward normals on back/left/right faces).
    st = cosig_tpu.RenderSettings(max_depth=1, debug_mode=1)
    depth_t = r.render(s, st)
    depth_a = r.render(s, st.replace(analytic_primitives=True))
    d = np.abs(depth_a - depth_t).max(axis=2)
    assert (d > 1e-3).mean() < 0.02
    assert np.median(d) < 1e-6
    # Shaded analytic render is finite and lit.
    img_a = r.render(
        s, cosig_tpu.RenderSettings(max_depth=1, analytic_primitives=True)
    )
    assert np.isfinite(img_a).all() and img_a.max() > 0.2


def test_analytic_nonuniform_scale_normals():
    # Ellipsoid (2,1,1): normals must come from the inverse-transpose.
    s = _sphere_scene()
    s.transformations[2] = CompositeTransformation(
        [TransformElement.scale((6, 3, 3))]
    )
    r = Renderer(backend="xla")
    st = cosig_tpu.RenderSettings(max_depth=1, analytic_primitives=True)
    img = r.render(s, st)
    assert np.isfinite(img).all()
    assert img.max() > 0.2
