"""Render-semantics tests with hand-computable expected values, plus
low-res smoke renders of the in-repo scene file.

These pin the shading math of compute:360-473 (ambient/diffuse/specular
terms, shadow test, reflection/refraction attenuation policy) to exact
closed-form values on synthetic scenes."""

import numpy as np
import pytest

from cosig_tpu.models.scene import (
    CameraSettings,
    CompositeTransformation,
    ImageSettings,
    LightSource,
    MaterialDescription,
    SceneData,
    TransformElement,
    Triangle,
    TrianglesMesh,
)
from cosig_tpu.models.settings import RenderSettings
from cosig_tpu.render.renderer import Renderer
from cosig_tpu.scene.parser import load_scene


def make_scene(materials, triangles, light_z=66.0, bg=(0.0, 0.0, 1.0)):
    """Camera at (0,0,10) looking -Z, light on the +Z axis."""
    s = SceneData(
        image=ImageSettings(horizontal=32, vertical=32, background=bg),
        transformations=[
            CompositeTransformation(),  # 0: identity (camera)
            CompositeTransformation([TransformElement.translation((0, 0, light_z))]),
        ],
        camera=CameraSettings(transformation_index=0, distance=10.0, vertical_fov_deg=60.0),
        lights=[LightSource(transformation_index=1, rgb=(1, 1, 1))],
        materials=materials,
        triangle_meshes=[TrianglesMesh(transformation_index=0, triangles=triangles)],
    )
    return s


BIG_TRI = [Triangle(0, (-50, -50, 0), (50, -50, 0), (0, 50, 0))]  # normal +Z


def center_px(img):
    return img[img.shape[0] // 2, img.shape[1] // 2]


@pytest.fixture(scope="module")
def renderer():
    return Renderer(backend="xla")


def test_empty_scene_is_background(renderer):
    s = SceneData(image=ImageSettings(16, 16, (0.3, 0.4, 0.5)))
    img = renderer.render(s, RenderSettings())
    np.testing.assert_allclose(img, np.broadcast_to((0.3, 0.4, 0.5), (16, 16, 3)), atol=1e-6)


def test_ambient_only_exact(renderer):
    mats = [MaterialDescription(color=(1, 0, 0), ambient=0.3, diffuse=0.5)]
    s = make_scene(mats, BIG_TRI)
    img = renderer.render(
        s,
        RenderSettings(enable_diffuse=False, light_intensity_scale=2.0),
    )
    # localColor = kA * color; pixel = local * intensity; no continuation.
    np.testing.assert_allclose(center_px(img), (0.6, 0.0, 0.0), atol=1e-5)


def test_full_blinn_phong_exact(renderer):
    kA, kD, kS = 0.1, 0.6, 0.25
    mats = [MaterialDescription(color=(0.0, 1.0, 0.0), ambient=kA, diffuse=kD, specular=kS)]
    s = make_scene(mats, BIG_TRI)
    img = renderer.render(s, RenderSettings(max_depth=1))
    # Center ray hits (0,0,0); N=(0,0,1); light at (0,0,66) -> NdotL=1;
    # view dir (0,0,1); half=(0,0,1) -> spec=1.
    expected = np.array([0, kA + kD, 0]) + kS * np.array([1, 1, 1])
    # The 32x32 center pixel sits half a pixel off-axis, so NdotL and the
    # pow-32 highlight are marginally below 1.
    np.testing.assert_allclose(center_px(img), expected, atol=2e-3)


def test_shadow_blocks_diffuse(renderer):
    kA, kD = 0.2, 0.7
    mats = [
        MaterialDescription(color=(1, 1, 1), ambient=kA, diffuse=kD),
        MaterialDescription(color=(1, 1, 1), ambient=0.0, diffuse=0.0),
    ]
    occluder = [Triangle(1, (-50, -50, 5), (50, -50, 5), (0, 50, 5))]
    s = make_scene(mats, BIG_TRI + occluder)
    img = renderer.render(s, RenderSettings(max_depth=1))
    # Camera at z=10 first hits the occluder plate at z=5 (which shades
    # nothing: kA=kD=0) — instead probe the base plate via a scene where the
    # occluder is SMALL and sits between (0,0,0) and the light.
    s2 = make_scene(
        mats,
        BIG_TRI + [Triangle(1, (-1, -1, 50), (1, -1, 50), (0, 1, 50))],
    )
    img2 = renderer.render(s2, RenderSettings(max_depth=1))
    # Center: shadowed -> ambient only. Far corner: lit.
    np.testing.assert_allclose(center_px(img2), (kA, kA, kA), atol=1e-4)
    corner = img2[1, 1]
    assert corner[0] > kA + 0.1  # diffuse present off-shadow


def test_mirror_reflects_background_exact(renderer):
    kS = 0.5
    mats = [MaterialDescription(color=(1.0, 0.5, 1.0), ambient=0.0, diffuse=0.0, specular=kS)]
    s = make_scene(mats, BIG_TRI, bg=(0.0, 0.0, 1.0))
    img = renderer.render(
        s,
        RenderSettings(
            max_depth=2, enable_ambient=False, enable_diffuse=False, enable_specular=False
        ),
    )
    # Bounce 1: local=0 (toggles off), atten *= color*kS; bounce 2: miss ->
    # + atten * bg. Note EnableSpecular=off still reflects (quirk).
    np.testing.assert_allclose(center_px(img), (0.0, 0.0, 0.5), atol=1e-5)


def test_refraction_straight_through_ior1(renderer):
    kR = 0.8
    mats = [MaterialDescription(color=(1.0, 1.0, 0.25), refraction=kR, ior=1.0)]
    s = make_scene(mats, BIG_TRI, bg=(1.0, 1.0, 1.0))
    img = renderer.render(
        s,
        RenderSettings(
            max_depth=2, enable_ambient=False, enable_diffuse=False
        ),
    )
    # ior=1 -> undeviated pass-through; second bounce misses -> color*kR*bg.
    np.testing.assert_allclose(center_px(img), (0.8, 0.8, 0.2), atol=1e-5)


def test_refraction_disabled_falls_back_to_reflection(renderer):
    mats = [MaterialDescription(color=(1, 1, 1), specular=0.25, refraction=0.9, ior=1.2)]
    s = make_scene(mats, BIG_TRI, bg=(1.0, 0.0, 0.0))
    img = renderer.render(
        s,
        RenderSettings(max_depth=2, enable_ambient=False, enable_diffuse=False,
                       enable_refraction=False),
    )
    # Refraction toggle off -> reflect with kS attenuation; reflected ray
    # goes back +Z and misses -> 0.25 * bg.
    np.testing.assert_allclose(center_px(img), (0.25, 0.0, 0.0), atol=1e-5)


def test_dead_end_ray_adds_nothing(renderer):
    # kS=0, kR=0 -> loop breaks after local shading; background NOT added.
    mats = [MaterialDescription(color=(0.5, 0.5, 0.5), ambient=1.0)]
    s = make_scene(mats, BIG_TRI, bg=(9.0, 9.0, 9.0))
    img = renderer.render(
        s, RenderSettings(max_depth=5, enable_diffuse=False)
    )
    np.testing.assert_allclose(center_px(img), (0.5, 0.5, 0.5), atol=1e-5)


def test_debug_mode_hit(renderer):
    mats = [MaterialDescription(color=(1, 1, 1), ambient=1.0)]
    s = make_scene(mats, BIG_TRI)
    img = renderer.render(s, RenderSettings(debug_mode=3))
    np.testing.assert_allclose(center_px(img), (0.0, 1.0, 0.0), atol=1e-6)
    # A triangle spanning (-50..50) at z=0 from fov 60 dist 10 covers the
    # whole 32x32 view; use an empty scene for the miss color instead.
    s_empty = SceneData(image=ImageSettings(16, 16, (0, 0, 0)))
    img2 = renderer.render(s_empty, RenderSettings(debug_mode=3))
    np.testing.assert_allclose(img2[0, 0], (0.2, 0.2, 0.2), atol=1e-6)


def test_determinism(renderer):
    mats = [MaterialDescription(color=(1, 0.2, 0.1), ambient=0.2, diffuse=0.6)]
    s = make_scene(mats, BIG_TRI)
    st = RenderSettings(aa_samples=4, enable_soft_shadows=True, light_size=5.0)
    a = renderer.render(s, st)
    b = renderer.render(s, st)
    np.testing.assert_array_equal(a, b)


def test_multi_light_mode(renderer):
    mats = [MaterialDescription(color=(1, 1, 1), ambient=0.0, diffuse=0.5)]
    s = make_scene(mats, BIG_TRI)
    s.lights.append(LightSource(transformation_index=1, rgb=(1.0, 0.0, 0.0)))
    img1 = renderer.render(s, RenderSettings(max_depth=1, multi_light=False))
    img2 = renderer.render(s, RenderSettings(max_depth=1, multi_light=True))
    c1, c2 = center_px(img1), center_px(img2)
    # Faithful mode ignores the second light entirely.
    np.testing.assert_allclose(c1, (0.5, 0.5, 0.5), atol=1e-4)
    # Multi-light adds the red light's contribution on top.
    np.testing.assert_allclose(c2, (1.0, 0.5, 0.5), atol=1e-4)


# ---------------------------------------------------------------------------
# The in-repo scene file, low-res smoke (CPU)


@pytest.mark.parametrize(
    "settings",
    [
        RenderSettings(resolution_override=(48, 48)),
        RenderSettings(resolution_override=(48, 48), aa_samples=4,
                       enable_soft_shadows=True, light_size=5.0),
        RenderSettings(resolution_override=(48, 48), max_depth=4, multi_light=True),
    ],
    ids=["default", "aa4_soft_shadows", "depth4_multi_light"],
)
def test_scene_file_renders(renderer, demo_scene_path, settings):
    s = load_scene(demo_scene_path)
    img = renderer.render(s, settings)
    assert img.shape == (48, 48, 3)
    assert np.isfinite(img).all()
    assert img.min() >= 0.0
    assert img.std() > 0.05  # non-degenerate content
    # Corners are background (the box does not reach the frame corners).
    np.testing.assert_allclose(img[0, 0], s.image.background, atol=1e-5)


def test_zero_scale_camera_transform_renders(renderer):
    """A singular camera transformation renders (identity fallback)
    instead of crashing."""
    import cosig_tpu

    s = cosig_tpu.parse_scene(
        "Image\n{\n8 8\n0.1 0.2 0.3\n}\n"
        "Transformation\n{\nS 0 0 0\n}\n"
        "Camera\n{\n0\n10\n60\n}\n"
    )
    img = renderer.render(s, RenderSettings(max_depth=1))
    assert img.shape == (8, 8, 3)
    assert np.isfinite(img).all()
