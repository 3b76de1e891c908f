"""Render orchestration: scene/acceleration caching, settings precedence,
backend selection, timing.

This is the JAX equivalent of ``Assets/Services/RayTracer.cs``:

* the compiled-scene (and BVH) cache keyed on scene identity
  mirrors the reference's BVH cache (RayTracer.cs:26-27,117-123,269-278) —
  camera motion never re-tessellates or re-uploads geometry;
* ``render`` is the static path (device->host readback included,
  RayTracer.cs:212-380); ``render_to_device`` is the realtime path that
  returns the device array without readback (RayTracer.cs:76-82);
* backends: ``"xla"`` (brute-force closest-hit at up to
  :data:`BVH_MIN_TRIANGLES` triangles, the per-ray BVH walk above),
  ``"xla-brute"`` (brute-force closest-hit at any scene size — the EXACT
  test oracle; the BVH walk's near-first traversal resolves equal-t ties
  by traversal order, not soup order, so it is not bit-identical to the
  oracle on ties); ``"auto"`` is ``"xla"``.
"""

from __future__ import annotations

import functools
import logging
import os
import time
from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from cosig_tpu.models.scene import SceneData
from cosig_tpu.models.settings import RenderSettings
from cosig_tpu.models.soa import (
    SceneArrays,
    compile_scene,
    frame_params,
    static_config,
)
from cosig_tpu.ops import trace_xla

log = logging.getLogger("cosig_tpu.render")

BACKENDS = ("auto", "xla", "xla-brute")
# Above this many triangles the "xla"/"auto" backend walks a BVH instead
# of scanning every triangle.
BVH_MIN_TRIANGLES = 4096


@dataclass
class RenderStats:
    width: int = 0
    height: int = 0
    triangles: int = 0
    compile_ms: float = 0.0
    render_ms: float = 0.0
    rays_traced: int = 0

    @property
    def mrays_per_s(self) -> float:
        if self.render_ms <= 0:
            return 0.0
        return self.rays_traced / (self.render_ms * 1e3)


class Renderer:
    """Stateful front end with scene-compilation caching."""

    def __init__(self, backend: str = "auto"):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
        self.backend = backend
        self.invalidate_cache()
        self.last_stats = RenderStats()

    # -- cache management (parity: InvalidateBVHCache, RayTracer.cs:38-42) --

    def invalidate_cache(self) -> None:
        self._cached_scene: Optional[SceneData] = None
        self._cached_arrays: Optional[SceneArrays] = None
        self._cached_tris = None
        self._cached_bvhdev = None
        self._analytic_scene: Optional[SceneData] = None
        self._analytic_arrays: Optional[SceneArrays] = None
        self._analytic_prims = None

    def _arrays_for(self, scene: SceneData) -> SceneArrays:
        if self._cached_scene is not scene or self._cached_arrays is None:
            from cosig_tpu.scene.tessellate import extract_triangles

            # Keep the host copy of the geometry: the BVH builder needs it,
            # and re-reading device arrays would cost device->host copies.
            self._cached_tris = extract_triangles(scene)
            self._cached_arrays = compile_scene(scene, self._cached_tris)
            self._cached_scene = scene
            self._cached_bvhdev = None
        return self._cached_arrays

    def _uses_bvh(self, num_triangles: int, cfg) -> bool:
        """Whether this frame takes the BVH walk instead of brute force."""
        return (
            self.backend != "xla-brute"
            and num_triangles > BVH_MIN_TRIANGLES
            and cfg.debug_mode == 0
        )

    # ------------------------------------------------------------------

    def render_to_device(self, scene: SceneData, settings: RenderSettings):
        """Realtime path: returns the device framebuffer [H, W, 3] f32
        (row 0 = bottom) with no host readback."""
        params = frame_params(scene, settings)
        cfg = static_config(scene, settings)

        t0 = time.perf_counter()
        rays = None
        if settings.analytic_primitives:
            # Analytic sphere/box mode (ops/analytic.py). Skips the
            # tessellated compile entirely — tessellating the spheres is
            # exactly the cost this mode avoids.
            from cosig_tpu.ops.analytic import compile_analytic
            from cosig_tpu.scene.tessellate import extract_triangles

            if self._analytic_scene is not scene:
                mesh_tris = extract_triangles(scene, include_primitives=False)
                self._analytic_arrays = compile_scene(scene, mesh_tris)
                self._analytic_prims = compile_analytic(scene)
                self._analytic_scene = scene
            arrays = self._analytic_arrays
            img = trace_xla.render_jit_analytic(
                arrays, self._analytic_prims, params, cfg
            )
        else:
            arrays = self._arrays_for(scene)
            if self._uses_bvh(arrays.num_triangles, cfg):
                # Large scenes: per-ray BVH walk (O(log T)) instead of the
                # brute-force O(T) oracle scan. backend="xla-brute" opts
                # out (exact-oracle escape hatch — see the module
                # docstring for the tie-break difference).
                from cosig_tpu.ops import bvh_traverse

                if self._cached_bvhdev is None:
                    self._cached_bvhdev = bvh_traverse.build_bvh_device(
                        self._cached_tris
                    )
                img, rays = bvh_traverse.render_jit_bvh(
                    arrays, self._cached_bvhdev, params, cfg, with_rays=True
                )
            else:
                img, rays = trace_xla.render_jit(
                    arrays, params, cfg, with_rays=True
                )
        img.block_until_ready()
        dt = (time.perf_counter() - t0) * 1e3

        self.last_stats = RenderStats(
            width=cfg.width,
            height=cfg.height,
            triangles=arrays.num_triangles,
            render_ms=dt,
            rays_traced=int(rays) if rays is not None else estimate_rays(cfg),
        )
        return img

    def render(self, scene: SceneData, settings: RenderSettings) -> np.ndarray:
        """Static path: render + synchronous device->host readback
        (RayTracer.cs:369-375). Returns [H, W, 3] f32 numpy, row 0 bottom."""
        return np.asarray(self.render_to_device(scene, settings))

    def render_chunked(
        self,
        scene: SceneData,
        settings: RenderSettings,
        rows_per_chunk: int = 64,
        checkpoint: Optional[str] = None,
        progress=None,
    ) -> np.ndarray:
        """Resumable chunked render: row bands rendered one at a time with
        an optional on-disk checkpoint (SURVEY.md section 5, checkpoint row
        — the per-tile render loop makes mid-render resume natural, which
        the reference's single-dispatch design cannot do).

        Interrupt at any point; re-running with the same ``checkpoint``
        path resumes after the last completed band. Uses the XLA path
        (row-offset rendering)."""
        arrays = self._arrays_for(scene)
        params = frame_params(scene, settings)
        cfg = static_config(scene, settings)
        h, w = cfg.height, cfg.width

        img = np.zeros((h, w, 3), np.float32)
        done_rows = 0
        if checkpoint and os.path.exists(checkpoint):
            data = np.load(checkpoint)
            if tuple(data["shape"]) == (h, w) and int(data["depth"]) == cfg.max_depth:
                img = data["img"]
                done_rows = int(data["done_rows"])
                log.info("resuming chunked render at row %d/%d", done_rows, h)

        render_rows = jax.jit(
            functools.partial(trace_xla.render_image, cfg=cfg),
            static_argnames=("rows",),
        )
        while done_rows < h:
            rows = min(rows_per_chunk, h - done_rows)
            band = render_rows(
                arrays, params, row_offset=jnp.int32(done_rows), rows=rows
            )
            img[done_rows : done_rows + rows] = np.asarray(band)
            done_rows += rows
            if checkpoint:
                # Write through a file handle: np.savez(path) appends
                # ".npz" to bare paths, which would break resume lookup.
                with open(checkpoint, "wb") as f:
                    np.savez(
                        f,
                        img=img,
                        done_rows=done_rows,
                        shape=(h, w),
                        depth=cfg.max_depth,
                    )
            if progress:
                progress(done_rows / h)
        if checkpoint and os.path.exists(checkpoint) and done_rows >= h:
            os.remove(checkpoint)
        return img

    def save_png(self, img, path: str) -> None:
        from cosig_tpu.utils.png import write_png

        write_png(path, np.asarray(img))


def estimate_rays(cfg) -> int:
    """Upper-bound ray count: W*H*AA*depth*(1 primary/secondary + 1 shadow)
    (SURVEY.md section 3.1). Actual live-ray counts are lower after early
    termination; benchmarks report both."""
    shadow = 1 if cfg.enable_diffuse else 0
    return cfg.width * cfg.height * cfg.aa_samples * cfg.max_depth * (1 + shadow)
