"""Benchmark harness — prints ONE JSON line.

Headline metric: live Mrays/s of the ``glass_sphere`` config (1024x1024,
depth-6 Whitted, 4x AA) rendered through ``Renderer.render_to_device`` on
one GPU. Rays are counted honestly: primary/secondary rays alive at each
bounce plus shadow rays actually cast, not the W*H*depth upper bound.

Each frame is timed on the host clock around work that ends in
``block_until_ready``; the result is the median over ``--repeats``
frames after one warm-up frame (which carries the compile).

Usage: python bench.py [--config NAME] [--all] [--repeats N]

``--all`` runs every config in its own child process; the parent never
touches a device, so each child gets the whole card. Any failed config
makes the run exit non-zero.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

CONFIG_NAMES = (
    "diffuse_sphere", "cosig_walls", "mirror_sphere", "glass_sphere", "large_mesh",
)


def device_info() -> dict:
    """The device JAX runs on, as its own attributes name it."""
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind, "count": len(jax.devices())}


def bench_config(name: str, repeats: int = 5, resolution: int | None = None) -> dict:
    """Render ``name`` ``repeats + 1`` times on the default device -> stats.

    ``resolution`` overrides the config's square frame size."""
    import jax
    import numpy as np

    from cosig_tpu.render.renderer import Renderer
    from cosig_tpu.scene.generate import CONFIGS
    from cosig_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    scene, settings = CONFIGS[name]()
    if resolution is not None:
        settings = settings.replace(resolution_override=(resolution, resolution))
    renderer = Renderer(backend="xla")

    t0 = time.perf_counter()
    img = renderer.render_to_device(scene, settings)
    compile_s = time.perf_counter() - t0  # first frame: compile + render
    frame_ms = []
    for _ in range(repeats):
        img = renderer.render_to_device(scene, settings)
        frame_ms.append(renderer.last_stats.render_ms)
    st = renderer.last_stats
    ms = statistics.median(frame_ms)
    out = np.asarray(img)
    return {
        "config": name,
        "device": device_info(),
        "resolution": [st.width, st.height],
        "max_depth": settings.max_depth,
        "aa": settings.aa_samples,
        "triangles": st.triangles,
        "frames_timed": repeats,
        "ms_per_frame": ms,
        "frame_ms": frame_ms,
        "rays_traced": st.rays_traced,
        "mrays_per_s": st.rays_traced / (ms * 1e3),
        "compile_s": compile_s,
        "peak_bytes_in_use": (jax.devices()[0].memory_stats() or {}).get(
            "peak_bytes_in_use"
        ),
        "lights": len(scene.lights) if settings.multi_light else 1,
        "image_finite": bool(np.isfinite(out).all()),
        "image_min": float(out.min()),
        "image_mean": float(out.mean()),
    }


def _require_gpu() -> None:
    import jax

    if jax.default_backend() != "gpu":
        raise SystemExit(
            f"bench.py measures a GPU; JAX found {jax.default_backend()!r}"
        )


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="glass_sphere", choices=CONFIG_NAMES)
    ap.add_argument("--all", action="store_true",
                    help="run all 5 configs, one child process each (details to stderr)")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--emit-details", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()

    if args.all:
        results, failed = {}, []
        for name in CONFIG_NAMES:
            cmd = [sys.executable, __file__, "--config", name,
                   "--repeats", str(args.repeats), "--emit-details"]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True, timeout=1800)
            except subprocess.TimeoutExpired:
                failed.append(name)
                print(f"{name}: FAILED (timed out)", file=sys.stderr)
                continue
            if proc.returncode != 0:
                failed.append(name)
                print(f"{name}: FAILED (exit {proc.returncode})\n{proc.stderr[-4000:]}",
                      file=sys.stderr)
                continue
            results[name] = json.loads(proc.stdout.strip().splitlines()[-1])
            print(json.dumps(results[name], indent=2), file=sys.stderr)
        headline = results.get("glass_sphere")
    else:
        _require_gpu()
        headline = bench_config(args.config, args.repeats)
        failed = [] if headline["image_finite"] else [args.config]
        if args.emit_details:
            print(json.dumps(headline))
            return 1 if failed else 0

    if headline is None:
        print(json.dumps({"metric": "Mrays/s glass_sphere (FAILED)", "value": 0.0,
                          "unit": "Mrays/s", "failed": failed}))
        return 1
    print(json.dumps({
        "metric": (
            f"Mrays/s {headline['config']} {headline['resolution'][0]}x"
            f"{headline['resolution'][1]} depth{headline['max_depth']} "
            f"aa{headline['aa']} (xla)"
        ),
        "value": headline["mrays_per_s"],
        "unit": "Mrays/s",
        "ms_per_frame": headline["ms_per_frame"],
        "device": headline["device"],
        "failed": failed,
    }))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
