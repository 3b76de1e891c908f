"""Device-ready structure-of-arrays scene representation.

This is the JAX replacement for the reference's GPU buffer uploads
(``Assets/Services/RayTracer.cs:396-403,455-499``): instead of three
``ComputeBuffer``s + ~25 uniforms, the scene compiles into two pytrees:

* :class:`SceneArrays` — geometry + materials (changes only when the scene
  changes; the acceleration structure is derived from it and cached);
* :class:`FrameParams` — per-frame dynamic floats (camera matrix, light,
  background, effect strengths) that can change without recompilation.

Shape-affecting knobs (resolution, depth, AA, toggles) live in
:class:`StaticConfig`, a hashable dataclass passed as a static jit argument.

Override precedence matches the reference exactly (RayTracer.cs:91-92,
162,179,221-222,322,339): settings overrides beat scene-file values, with
fallbacks fov 50, distance 30, 256x256, background (0.2,0.2,0.2).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from cosig_tpu.models.scene import SceneData
from cosig_tpu.models.settings import RenderSettings
from cosig_tpu.scene import transforms as tf
from cosig_tpu.scene.tessellate import TriangleSoA, extract_triangles

F32 = np.float32


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class SceneArrays:
    """Geometry + materials, object space, ready for the tracer."""

    tri_v0: jax.Array  # [T, 3] f32
    tri_v1: jax.Array  # [T, 3]
    tri_v2: jax.Array  # [T, 3]
    tri_n0: jax.Array  # [T, 3]
    tri_n1: jax.Array  # [T, 3]
    tri_n2: jax.Array  # [T, 3]
    tri_mat: jax.Array  # [T] i32
    mat_color: jax.Array  # [M, 3] f32
    mat_coeff: jax.Array  # [M, 5] f32: ambient, diffuse, specular, refraction, ior

    @property
    def num_triangles(self) -> int:
        return int(self.tri_v0.shape[0])

    @property
    def num_materials(self) -> int:
        return int(self.mat_color.shape[0])

    def tree_flatten(self):
        return (
            (
                self.tri_v0, self.tri_v1, self.tri_v2,
                self.tri_n0, self.tri_n1, self.tri_n2,
                self.tri_mat, self.mat_color, self.mat_coeff,
            ),
            None,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class FrameParams:
    """Per-frame dynamic parameters (all traced; change freely per call)."""

    cam_to_obj: jax.Array  # [4, 4] f32 — camera-space -> object-space ray transform
    cam_distance: jax.Array  # scalar f32
    fov_deg: jax.Array  # scalar f32
    ortho_size: jax.Array  # scalar f32 = distance * tan(fov/2) (RayTracer.cs:187)
    background: jax.Array  # [3] f32
    light_pos: jax.Array  # [L, 3] f32 (L=1 in faithful mode)
    light_rgb: jax.Array  # [L, 3] f32 (all-ones in faithful mode)
    light_intensity: jax.Array  # scalar f32
    light_size: jax.Array  # scalar f32 (soft shadows)
    surface_roughness: jax.Array  # scalar f32 (glossy)
    shutter_speed: jax.Array  # scalar f32 (motion blur)

    def tree_flatten(self):
        return (
            (
                self.cam_to_obj, self.cam_distance, self.fov_deg, self.ortho_size,
                self.background, self.light_pos, self.light_rgb,
                self.light_intensity, self.light_size, self.surface_roughness,
                self.shutter_speed,
            ),
            None,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@dataclass(frozen=True)
class StaticConfig:
    """Hashable knobs that affect compiled shapes / control flow."""

    width: int
    height: int
    max_depth: int = 2
    aa_samples: int = 1
    enable_ambient: bool = True
    enable_diffuse: bool = True
    enable_specular: bool = True
    enable_refraction: bool = True
    is_orthographic: bool = False
    enable_soft_shadows: bool = False
    enable_glossy: bool = False
    enable_motion_blur: bool = False
    multi_light: bool = False
    debug_mode: int = 0


# ---------------------------------------------------------------------------
# Compilation from the parsed scene


def materials_host(scene: SceneData) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side material tables (color [M,3], coeff [M,5]); white-diffuse
    fallback when the scene has none (RayTracer.cs:455-474)."""
    if scene.materials:
        mat_color = np.array([m.color for m in scene.materials], dtype=F32)
        mat_coeff = np.array(
            [[m.ambient, m.diffuse, m.specular, m.refraction, m.ior] for m in scene.materials],
            dtype=F32,
        )
    else:
        mat_color = np.array([[1.0, 1.0, 1.0]], dtype=F32)
        mat_coeff = np.array([[0.1, 0.7, 0.0, 0.0, 1.0]], dtype=F32)
    return mat_color, mat_coeff


def compile_scene(scene: SceneData, tris: Optional[TriangleSoA] = None) -> SceneArrays:
    """Tessellate + pack the scene into device arrays."""
    if tris is None:
        tris = extract_triangles(scene)

    mat_color, mat_coeff = materials_host(scene)

    return SceneArrays(
        tri_v0=jnp.asarray(tris.v0),
        tri_v1=jnp.asarray(tris.v1),
        tri_v2=jnp.asarray(tris.v2),
        tri_n0=jnp.asarray(tris.n0),
        tri_n1=jnp.asarray(tris.n1),
        tri_n2=jnp.asarray(tris.n2),
        tri_mat=jnp.asarray(tris.material),
        mat_color=jnp.asarray(mat_color),
        mat_coeff=jnp.asarray(mat_coeff),
    )


def resolve_resolution(scene: SceneData, settings: RenderSettings) -> Tuple[int, int]:
    """Settings override > scene image > 256x256 (RayTracer.cs:221-222)."""
    if settings.resolution_override is not None:
        return int(settings.resolution_override[0]), int(settings.resolution_override[1])
    if scene.image is not None:
        return max(1, scene.image.horizontal), max(1, scene.image.vertical)
    return 256, 256


def camera_to_object_matrix(scene: SceneData, settings: RenderSettings) -> np.ndarray:
    """The ray transform: camera space -> object space.

    Scene-file semantics keep the camera fixed and move the scene; the
    renderer instead transforms rays by the inverse (RayTracer.cs:224-267).
    UI pos/rot overrides build a TRS and invert it (RayTracer.cs:249-261).
    """
    using_overrides = (
        settings.camera_position_override is not None
        or settings.camera_rotation_override is not None
    )
    if using_overrides:
        pos = settings.camera_position_override or (0.0, 0.0, 0.0)
        rot = settings.camera_rotation_override or (0.0, 0.0, 0.0)
        return tf.inverse(tf.trs_euler(pos, rot))
    m_scene = tf.identity()
    if (
        scene.camera is not None
        and 0 <= scene.camera.transformation_index < len(scene.transformations)
    ):
        m_scene = tf.build_composite(
            scene.transformations[scene.camera.transformation_index]
        )
    return tf.inverse(m_scene)


def light_positions(scene: SceneData, multi_light: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Light position(s) in object space.

    Faithful mode: only lights[0], position = translation column of its
    composite matrix, color forced white (RayTracer.cs:165-176; the shader
    never reads light RGB, compute:383-418). Multi-light mode: all lights
    with their RGB (capability extension).
    """
    def pos_of(light):
        if 0 <= light.transformation_index < len(scene.transformations):
            m = tf.build_composite(scene.transformations[light.transformation_index])
            return m[:3, 3]
        return np.zeros(3, dtype=F32)

    if not scene.lights:
        return np.zeros((1, 3), dtype=F32), np.ones((1, 3), dtype=F32)
    if multi_light:
        pos = np.stack([pos_of(l) for l in scene.lights]).astype(F32)
        rgb = np.array([l.rgb for l in scene.lights], dtype=F32)
        return pos, rgb
    return pos_of(scene.lights[0]).reshape(1, 3).astype(F32), np.ones((1, 3), dtype=F32)


def frame_params(scene: SceneData, settings: RenderSettings) -> FrameParams:
    """Assemble per-frame dynamic parameters with reference precedence."""
    fov = (
        settings.camera_fov_override
        if settings.camera_fov_override is not None
        else (scene.camera.vertical_fov_deg if scene.camera is not None else 50.0)
    )
    distance = scene.camera.distance if scene.camera is not None else 30.0
    bg = (
        settings.background_color_override
        if settings.background_color_override is not None
        else (scene.image.background if scene.image is not None else (0.2, 0.2, 0.2))
    )
    lp, lrgb = light_positions(scene, settings.multi_light)
    ortho_size = distance * np.tan(np.deg2rad(F32(fov)) * F32(0.5))

    return FrameParams(
        cam_to_obj=jnp.asarray(camera_to_object_matrix(scene, settings)),
        cam_distance=jnp.float32(distance),
        fov_deg=jnp.float32(fov),
        ortho_size=jnp.float32(ortho_size),
        background=jnp.asarray(np.asarray(bg, dtype=F32)),
        light_pos=jnp.asarray(lp),
        light_rgb=jnp.asarray(lrgb),
        light_intensity=jnp.float32(settings.light_intensity_scale),
        light_size=jnp.float32(settings.light_size),
        surface_roughness=jnp.float32(settings.surface_roughness),
        shutter_speed=jnp.float32(settings.shutter_speed),
    )


def static_config(scene: SceneData, settings: RenderSettings) -> StaticConfig:
    width, height = resolve_resolution(scene, settings)
    return StaticConfig(
        width=width,
        height=height,
        max_depth=settings.max_depth,
        aa_samples=max(1, settings.aa_samples),
        enable_ambient=settings.enable_ambient,
        enable_diffuse=settings.enable_diffuse,
        enable_specular=settings.enable_specular,
        enable_refraction=settings.enable_refraction,
        is_orthographic=settings.is_orthographic,
        enable_soft_shadows=settings.enable_soft_shadows,
        enable_glossy=settings.enable_glossy,
        enable_motion_blur=settings.enable_motion_blur,
        multi_light=settings.multi_light,
        debug_mode=settings.debug_mode,
    )
