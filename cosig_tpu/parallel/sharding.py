"""Multi-chip rendering: shard the framebuffer over a device mesh.

The reference is single-process single-GPU; its only parallelism is one
thread per pixel (SURVEY.md section 2, parallelism inventory). The
multi-device scaling story here (SURVEY.md section 5, last two rows):

* geometry + materials are tiny (~130 KB/scene) -> **replicated**;
* the framebuffer is sharded over a 1-D mesh of row bands (the pixel
  domain is this workload's batch axis) via ``shard_map``;
* tracing is embarrassingly parallel -> **zero collectives during the
  frame**; the sharded output array is the gather (XLA materializes it
  on demand).

This scales to any mesh shape: for a 2-D mesh, reshape the band axis over
both mesh axes (rows x cols tiling would only matter for load balance).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from cosig_tpu.models.soa import FrameParams, SceneArrays, StaticConfig
from cosig_tpu.ops import trace_xla


def make_mesh(n_devices: Optional[int] = None, axis: str = "rows") -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis,))


def _pad_height(height: int, n: int) -> int:
    return -(-height // n) * n


def render_sharded(
    scene: SceneArrays,
    params: FrameParams,
    cfg: StaticConfig,
    mesh: Mesh,
):
    """Render with the framebuffer sharded over ``mesh``'s first axis.

    Returns a global [H, W, 3] array (sharded across devices; convert with
    ``np.asarray`` to gather to host). Semantics identical to the
    single-chip render — each shard computes its row band with the true
    global pixel coordinates."""
    axis = mesh.axis_names[0]
    n = mesh.devices.size
    h_pad = _pad_height(cfg.height, n)
    local_h = h_pad // n

    # Per-shard row offsets, sharded along the mesh axis.
    offsets = jnp.arange(n, dtype=jnp.int32) * local_h

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(axis)),
        out_specs=P(axis),
        check_vma=False,
    )
    def shard_fn(scene_rep, params_rep, offset):
        # cfg keeps the GLOBAL width/height (the projection plane is
        # global); only the rendered row band is local.
        return trace_xla.render_image(
            scene_rep, params_rep, cfg, row_offset=offset[0], rows=local_h
        )

    img = shard_fn(scene, params, offsets)
    return img[: cfg.height]


@functools.partial(jax.jit, static_argnames=("cfg", "mesh"))
def render_sharded_jit(scene, params, cfg: StaticConfig, mesh: Mesh):
    return render_sharded(scene, params, cfg, mesh)
