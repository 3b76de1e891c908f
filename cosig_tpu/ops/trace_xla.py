"""Pure-XLA wavefront Whitted tracer — the framework's oracle path.

This is the reference's per-pixel recursive GPU kernel
(``Assets/Shaders/BVHRayTracing.compute:273-511``) restructured as one
array program (SURVEY.md section 7, step 2):

* one batched computation over all pixels (SPMD over the pixel grid is an
  array axis, not threads);
* the recursive reflection/refraction is an iterative ``lax.fori_loop``
  over bounce depth carrying (origin, direction, attenuation, accumulated
  color, alive-mask) — the same loop-with-attenuation rewrite the
  reference's own shader performs (compute:356-473);
* pixels are processed in row-tiles via ``lax.map`` (pixel-domain blocking)
  so arbitrary resolutions bound memory;
* the closest-hit routine is pluggable: brute force (oracle) or an
  accelerated traversal.

The always-exact optimization beyond the reference: rays whose attenuation
reaches exactly zero are killed (a miss would add atten * bg == 0, so this
changes nothing numerically).
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp

from cosig_tpu.models.soa import FrameParams, SceneArrays, StaticConfig
from cosig_tpu.ops import camera, rng
from cosig_tpu.ops.intersect import Hit, closest_hit_brute, normalize, _dot
from cosig_tpu.ops.shade import (
    OFFSET,
    fetch_material,
    lambert_blinn_phong,
    secondary_ray,
)

F = jnp.float32

DEFAULT_PIXEL_TILE = 8192


def trace_sample(
    scene: SceneArrays,
    params: FrameParams,
    cfg: StaticConfig,
    px,
    py,
    sample_idx: int,
    closest_hit: Callable[..., Hit],
):
    """Trace one AA sample for a batch of pixels -> (color [N, 3],
    rays [N]): per-pixel color and the live-ray count (primary/secondary
    rays alive at each bounce + shadow rays actually cast).

    Follows compute:296-473 statement-for-statement (see shade.py for the
    preserved quirks)."""
    n = px.shape[0]
    ox, oy = camera.sample_offsets(px, py, sample_idx, cfg.aa_samples)
    o, d = camera.generate_rays(
        px, py, ox, oy,
        cfg.width, cfg.height,
        params.cam_to_obj, params.cam_distance, params.fov_deg,
        params.ortho_size, cfg.is_orthographic,
    )

    if cfg.enable_motion_blur:
        # World-origin shake (compute:342-349); note the uncentered
        # RandomUnitVector - 0.5 quirk.
        shake = (
            rng.random_unit_vector(px + F(sample_idx), py, jnp.full_like(px, sample_idx))
            - F(0.5)
        ) * F(0.2) * params.shutter_speed
        o = o + shake

    color = jnp.zeros((n, 3), F)
    atten = jnp.ones((n, 3), F)
    alive = jnp.ones((n,), bool)
    rays = jnp.zeros((n,), F)
    num_lights = int(params.light_pos.shape[0]) if cfg.multi_light else 1

    def bounce(depth, carry):
        o, d, atten, color, alive, rays = carry
        rays = rays + alive.astype(F)
        h = closest_hit(scene, o, d)

        # Miss: add attenuation-weighted background once, then die
        # (compute:364-368).
        miss = alive & ~h.hit
        color = color + jnp.where(miss[:, None], atten * params.background, F(0.0))
        alive = alive & h.hit

        mat = fetch_material(scene, h.material)
        local = jnp.zeros((n, 3), F)
        if cfg.enable_ambient:
            local = local + mat.color * mat.ambient[:, None]

        view_dir = -d  # d is unit length, so normalize(-d) == -d
        depth_f = depth.astype(F)

        for li in range(num_lights):
            light_pos = params.light_pos[li]
            if cfg.enable_soft_shadows:
                # Jittered light position (compute:383-388).
                jitter = rng.random_unit_vector(
                    px + F(sample_idx * 9.0),
                    py + F(sample_idx * 4.0) + depth_f,
                    jnp.full_like(px, sample_idx),
                ) * params.light_size
                light_pos = light_pos + jitter

            to_light = light_pos - h.position
            dist_to_light = jnp.sqrt(_dot(to_light, to_light))
            light_dir = normalize(to_light)
            n_dot_l = jnp.maximum(F(0.0), _dot(h.normal, light_dir))

            if cfg.enable_diffuse:
                rays = rays + (alive & (n_dot_l > F(0.0))).astype(F)
                shadow_o = h.position + h.normal * OFFSET
                sh = closest_hit(scene, shadow_o, light_dir)
                lit = (~sh.hit) | (sh.t > dist_to_light)
            else:
                lit = jnp.ones((n,), bool)

            light_rgb = params.light_rgb[li] if cfg.multi_light else jnp.ones(3, F)
            local = local + lambert_blinn_phong(
                mat, h.normal, light_dir, view_dir, n_dot_l, lit, light_rgb,
                cfg.enable_diffuse, cfg.enable_specular,
            )

        color = color + jnp.where(
            alive[:, None], atten * local * params.light_intensity, F(0.0)
        )

        sec = secondary_ray(mat, h.position, h.normal, d, cfg.enable_refraction)
        next_dir = sec.next_dir
        if cfg.enable_glossy:
            # Perturb the continuation direction (compute:459-470).
            jitter = rng.random_unit_vector(
                px + F(sample_idx * 55.0) + depth_f,
                py + F(sample_idx * 22.0),
                jnp.full_like(px, 13.0) * depth_f,
            ) * params.surface_roughness
            next_dir = normalize(next_dir + jitter)

        cont = alive & sec.continue_ray
        atten = jnp.where(cont[:, None], atten * sec.atten_mult, atten)
        o = jnp.where(cont[:, None], sec.next_origin, o)
        d = jnp.where(cont[:, None], normalize(next_dir), d)
        # Exact-zero attenuation contributes nothing downstream; kill it.
        cont = cont & (jnp.max(atten, axis=-1) > F(0.0))
        return o, d, atten, color, cont, rays

    _, _, _, color, _, rays = jax.lax.fori_loop(
        0, cfg.max_depth, bounce, (o, d, atten, color, alive, rays)
    )
    return color, rays


def trace_pixels(
    scene: SceneArrays,
    params: FrameParams,
    cfg: StaticConfig,
    px,
    py,
    closest_hit: Callable[..., Hit] = closest_hit_brute,
):
    """Average ``cfg.aa_samples`` traced samples per pixel ->
    (color [N, 3], rays [N] summed across samples)."""
    accum = jnp.zeros((px.shape[0], 3), F)
    rays = jnp.zeros((px.shape[0],), F)
    for i in range(cfg.aa_samples):
        c, r = trace_sample(scene, params, cfg, px, py, i, closest_hit)
        accum = accum + c
        rays = rays + r
    return accum / F(cfg.aa_samples), rays


def debug_pixels(
    scene: SceneArrays,
    params: FrameParams,
    cfg: StaticConfig,
    px,
    py,
    closest_hit: Callable[..., Hit] = closest_hit_brute,
):
    """Debug visualizations 1=depth 2=normals 3=hit (compute:484-508).

    The reference always uses a *perspective* center ray here regardless of
    the ortho toggle; preserved."""
    half = jnp.full_like(px, 0.5)
    o, d = camera.generate_rays(
        px, py, half, half,
        cfg.width, cfg.height,
        params.cam_to_obj, params.cam_distance, params.fov_deg,
        params.ortho_size, False,
    )
    h = closest_hit(scene, o, d)
    rays = jnp.ones((px.shape[0],), F)
    if cfg.debug_mode == 1:
        gray = (h.t / F(100.0))[:, None] * jnp.ones(3, F)
        return (
            jnp.where(h.hit[:, None], gray, jnp.array([1.0, 0.0, 0.0], F)),
            rays,
        )
    if cfg.debug_mode == 2:
        return (
            jnp.where(
                h.hit[:, None], h.normal * F(0.5) + F(0.5),
                jnp.array([0.0, 0.0, 1.0], F),
            ),
            rays,
        )
    return (
        jnp.where(
            h.hit[:, None],
            jnp.array([0.0, 1.0, 0.0], F),
            jnp.array([0.2, 0.2, 0.2], F),
        ),
        rays,
    )


def render_image(
    scene: SceneArrays,
    params: FrameParams,
    cfg: StaticConfig,
    closest_hit: Callable[..., Hit] = closest_hit_brute,
    pixel_tile: int = DEFAULT_PIXEL_TILE,
    row_offset=0,
    rows: int = None,
    with_rays: bool = False,
):
    """Render frame rows [row_offset, row_offset+rows) -> [rows, W, 3] f32,
    row 0 at the bottom of the global image; with ``with_rays`` returns
    (image, live-ray count).

    ``rows``/``row_offset`` support framebuffer sharding: the projection
    plane always uses the GLOBAL cfg.width/cfg.height, only the rendered
    band is restricted. Pixels are processed in tiles via ``lax.map`` so
    temporaries stay bounded regardless of resolution."""
    w, h = cfg.width, (cfg.height if rows is None else rows)
    n = w * h
    ys, xs = jnp.meshgrid(
        jnp.arange(h, dtype=F), jnp.arange(w, dtype=F), indexing="ij"
    )
    px = xs.reshape(-1)
    py = ys.reshape(-1) + jnp.asarray(row_offset, F)

    tile = min(pixel_tile, n)
    pad = (-n) % tile
    if pad:
        px = jnp.concatenate([px, jnp.zeros((pad,), F)])
        py = jnp.concatenate([py, jnp.zeros((pad,), F)])

    fn = debug_pixels if cfg.debug_mode != 0 else trace_pixels

    def tile_fn(args):
        tpx, tpy = args
        return fn(scene, params, cfg, tpx, tpy, closest_hit)

    out, rays = jax.lax.map(
        tile_fn, (px.reshape(-1, tile), py.reshape(-1, tile))
    )
    img = out.reshape(-1, 3)[:n].reshape(h, w, 3)
    if with_rays:
        return img, jnp.sum(rays.reshape(-1)[:n])
    return img


@functools.partial(jax.jit, static_argnames=("cfg", "pixel_tile", "with_rays"))
def render_jit(scene, params, cfg: StaticConfig,
               pixel_tile: int = DEFAULT_PIXEL_TILE, with_rays: bool = False):
    return render_image(
        scene, params, cfg, pixel_tile=pixel_tile, with_rays=with_rays
    )


@functools.partial(jax.jit, static_argnames=("cfg", "pixel_tile"))
def render_jit_analytic(
    scene, prims, params, cfg: StaticConfig, pixel_tile: int = DEFAULT_PIXEL_TILE
):
    """Render with analytic sphere/box intersection (ops/analytic.py)."""
    from cosig_tpu.ops.analytic import closest_hit_analytic

    def ch(s, o, d):
        return closest_hit_analytic(s, prims, o, d)

    return render_image(scene, params, cfg, closest_hit=ch, pixel_tile=pixel_tile)
