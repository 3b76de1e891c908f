"""cosig_tpu — a JAX/XLA Whitted ray-tracing framework.

A ground-up rebuild of the capabilities of mpoboas/cosig-raytracing
(Unity C# + HLSL compute shader) as an idiomatic JAX framework:

* the scene becomes structure-of-arrays ``jnp`` buffers,
* the per-pixel recursive GPU kernel becomes a pure jitted function over
  the whole image (wavefront depth loop with attenuation carry),
* closest hit is a brute-force scan over triangle blocks for small scenes
  and a per-ray BVH walk for large ones,
* multi-device scaling is ``shard_map`` over framebuffer tiles with
  replicated geometry.

Layer map (mirrors the reference's layers, reference file cited in each
module):

* ``cosig_tpu.models``    — scene data model, render settings, presets
* ``cosig_tpu.scene``     — scene-file parser, transforms, tessellation
* ``cosig_tpu.accel``     — BVH acceleration structure
* ``cosig_tpu.ops``       — intersection, shading, RNG, camera ray-gen
* ``cosig_tpu.render``    — renderer orchestration
* ``cosig_tpu.parallel``  — device-mesh sharding of the framebuffer
* ``cosig_tpu.utils``     — PNG/GIF writers, compile-cache placement
* ``cosig_tpu.native``    — optional C++ components (BVH builder, GIF LZW)
"""

__version__ = "0.1.0"

from cosig_tpu.models.scene import SceneData
from cosig_tpu.models.settings import RenderSettings
from cosig_tpu.scene.parser import load_scene, parse_scene


def Renderer(*args, **kwargs):
    """Lazy alias for :class:`cosig_tpu.render.renderer.Renderer` (keeps
    ``import cosig_tpu`` light — no jax import until first use)."""
    from cosig_tpu.render.renderer import Renderer as _R

    return _R(*args, **kwargs)


__all__ = [
    "SceneData",
    "RenderSettings",
    "Renderer",
    "load_scene",
    "parse_scene",
    "__version__",
]
