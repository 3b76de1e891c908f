"""Command-line application layer.

The replacement for the reference's UI controller
(``Assets/SceneBuilder.cs``): scene loading, static renders with timing
(:540-618), turntable GIF export (:965-1045), preset save/load
(:1057-1252), reference-image comparison (:1254-1280), and the scene
summary dump (:1393-1411) — as CLI subcommands instead of UI Toolkit
widgets (SURVEY.md section 7, non-goals).

Subcommands:

* ``render``    — render a scene file (or a named generated config) to PNG
* ``turntable`` — 36-frame rotating-camera animated GIF
* ``preview``   — realtime render loop with an FPS readout
* ``preset``    — save/load JSON presets (reference-compatible schema)
* ``compare``   — RMSE/PSNR between two images (the A/B panel, as a tool)
* ``info``      — parsed-scene summary + acceleration-structure stats
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _add_render_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("scene", help="scene .txt path, or generated:<config-name>")
    p.add_argument("-o", "--output", default="render.png")
    p.add_argument("--backend", default="auto", choices=["auto", "xla", "xla-brute"])
    p.add_argument("--width", type=int)
    p.add_argument("--height", type=int)
    p.add_argument("--depth", type=int, default=None, help="max bounce depth")
    p.add_argument("--aa", type=int, default=None)
    p.add_argument("--fov", type=float)
    p.add_argument("--intensity", type=float, default=None)
    p.add_argument("--background", type=float, nargs=3, metavar=("R", "G", "B"))
    p.add_argument("--camera-pos", type=float, nargs=3, metavar=("X", "Y", "Z"))
    p.add_argument("--camera-rot", type=float, nargs=3, metavar=("RX", "RY", "RZ"))
    p.add_argument("--ortho", action="store_true")
    p.add_argument("--no-ambient", action="store_true")
    p.add_argument("--no-diffuse", action="store_true")
    p.add_argument("--no-specular", action="store_true")
    p.add_argument("--no-refraction", action="store_true")
    p.add_argument("--soft-shadows", type=float, metavar="LIGHT_SIZE")
    p.add_argument("--glossy", type=float, metavar="ROUGHNESS")
    p.add_argument("--motion-blur", type=float, metavar="SHUTTER")
    p.add_argument("--multi-light", action="store_true")
    p.add_argument("--analytic", action="store_true",
                   help="analytic sphere/box intersection instead of tessellation")
    p.add_argument("--debug-mode", type=int, default=0, choices=[0, 1, 2, 3])
    p.add_argument("--preset", help="load settings from a preset JSON first")
    p.add_argument("--profile", metavar="DIR",
                   help="capture a jax.profiler trace of the render into DIR")


def _load_scene_arg(arg: str):
    from cosig_tpu.scene.parser import load_scene

    if arg.startswith("generated:"):
        from cosig_tpu.scene.generate import CONFIGS

        name = arg.split(":", 1)[1]
        scene, settings = CONFIGS[name]()
        return scene, settings
    from cosig_tpu.models.settings import RenderSettings

    return load_scene(arg), RenderSettings()


def _settings_from_args(args, base):
    s = base
    if args.preset:
        from cosig_tpu.models.preset import ScenePreset

        s = ScenePreset.load(args.preset).to_render_settings()
    kw = {}
    if args.width or args.height:
        w = args.width or (args.height or 256)
        h = args.height or w
        kw["resolution_override"] = (w, h)
    if args.depth is not None:
        kw["max_depth"] = args.depth
    if args.aa is not None:
        kw["aa_samples"] = args.aa
    if args.fov is not None:
        kw["camera_fov_override"] = args.fov
    if args.intensity is not None:
        kw["light_intensity_scale"] = args.intensity
    if args.background:
        kw["background_color_override"] = tuple(args.background)
    if args.camera_pos:
        kw["camera_position_override"] = tuple(args.camera_pos)
    if args.camera_rot:
        kw["camera_rotation_override"] = tuple(args.camera_rot)
    if args.ortho:
        kw["is_orthographic"] = True
    if args.no_ambient:
        kw["enable_ambient"] = False
    if args.no_diffuse:
        kw["enable_diffuse"] = False
    if args.no_specular:
        kw["enable_specular"] = False
    if args.no_refraction:
        kw["enable_refraction"] = False
    if args.soft_shadows is not None:
        kw["enable_soft_shadows"] = True
        kw["light_size"] = args.soft_shadows
    if args.glossy is not None:
        kw["enable_glossy"] = True
        kw["surface_roughness"] = args.glossy
    if args.motion_blur is not None:
        kw["enable_motion_blur"] = True
        kw["shutter_speed"] = args.motion_blur
    if args.multi_light:
        kw["multi_light"] = True
    if getattr(args, "analytic", False):
        kw["analytic_primitives"] = True
    if args.debug_mode:
        kw["debug_mode"] = args.debug_mode
    return s.replace(**kw) if kw else s


def cmd_render(args) -> int:
    from cosig_tpu.render.renderer import Renderer
    from cosig_tpu.utils.png import write_png

    import contextlib

    scene, base = _load_scene_arg(args.scene)
    settings = _settings_from_args(args, base)
    renderer = Renderer(backend=args.backend)

    if getattr(args, "profile", None):
        import jax

        tracer = jax.profiler.trace(args.profile)
    else:
        tracer = contextlib.nullcontext()

    t0 = time.perf_counter()
    with tracer:
        if getattr(args, "chunk_rows", None):
            img = renderer.render_chunked(
                scene, settings, rows_per_chunk=args.chunk_rows,
                checkpoint=args.checkpoint,
                progress=lambda f: print(f"\rchunks: {f*100:.0f}%", end="", flush=True),
            )
            print()
        else:
            img = renderer.render(scene, settings)
    dt = time.perf_counter() - t0
    if getattr(args, "profile", None):
        print(f"profiler trace -> {args.profile}")
    write_png(args.output, img)
    st = renderer.last_stats
    print(
        f"rendered {st.width}x{st.height} ({st.triangles} tris) in "
        f"{dt:.2f}s [{renderer.backend}] -> {args.output}"
    )
    if st.rays_traced:
        print(f"rays traced: {st.rays_traced:,} ({st.mrays_per_s:.1f} Mrays/s)")
    return 0


def cmd_turntable(args) -> int:
    from cosig_tpu.render.renderer import Renderer
    from cosig_tpu.utils.gif import save_gif, turntable_frames

    scene, base = _load_scene_arg(args.scene)
    settings = _settings_from_args(args, base)
    if settings.camera_rotation_override is None:
        settings = settings.replace(camera_rotation_override=(0.0, 0.0, 0.0))
    renderer = Renderer(backend=args.backend)

    t0 = time.perf_counter()
    frames = turntable_frames(
        renderer, scene, settings, steps=args.steps,
        progress=lambda f: print(f"\rframes: {f*100:.0f}%", end="", flush=True),
    )
    print()
    save_gif(frames, args.output, delay_cs=args.delay)
    print(
        f"GIF: {time.perf_counter()-t0:.2f}s ({len(frames)} frames) -> {args.output}"
    )
    return 0


def cmd_preview(args) -> int:
    """Realtime preview loop: repeated renders with an orbiting camera and
    an FPS readout — the reference's Update() loop + FPS label
    (SceneBuilder.cs:501,520-538), headless.

    Matches the reference's realtime contract (RayTracer.cs:76-82 binds
    the RenderTexture directly — the realtime loop NEVER reads the frame
    back to host): every frame goes through ``render_to_device``, and the
    loop issues zero device->host copies. One scalar readback after the
    loop forces completion of the whole enqueue chain (the device executes
    in launch order), so the FPS figure covers real render work without
    per-frame sync stalls. ``--save-dir`` reads frames back AFTER the loop
    (the static path)."""
    from cosig_tpu.render.renderer import Renderer
    from cosig_tpu.utils.png import write_png

    scene, base = _load_scene_arg(args.scene)
    settings = _settings_from_args(args, base)
    renderer = Renderer(backend=args.backend)
    rot = settings.camera_rotation_override or (0.0, 0.0, 0.0)

    frames_dev = []
    t_start = time.perf_counter()
    for i in range(args.frames):
        s = settings.replace(
            camera_rotation_override=(rot[0], rot[1], rot[2] + i * args.orbit)
        )
        frames_dev.append(renderer.render_to_device(scene, s))
        print(f"\rframe {i+1}/{args.frames} enqueued", end="", flush=True)
    # The single readback: one scalar forces the whole chain.
    _ = float(frames_dev[-1][0, 0, 0])
    total = time.perf_counter() - t_start
    print(f"\n{args.frames} frames in {total:.2f}s ({args.frames/total:.2f} FPS avg)")
    if args.save_dir:
        for i, img in enumerate(frames_dev):
            write_png(f"{args.save_dir}/frame_{i:04d}.png", np.asarray(img))
        print(f"saved {len(frames_dev)} frames -> {args.save_dir}")
    return 0


def cmd_compare(args) -> int:
    from cosig_tpu.utils.png import read_png

    a = read_png(args.image_a).astype(np.float64) / 255.0
    b = read_png(args.image_b).astype(np.float64) / 255.0
    if a.shape != b.shape:
        print(f"shape mismatch: {a.shape} vs {b.shape}", file=sys.stderr)
        return 1
    mse = float(((a - b) ** 2).mean())
    rmse = mse ** 0.5
    psnr = 10 * np.log10(1.0 / mse) if mse > 0 else float("inf")
    result = {"rmse": rmse, "psnr_db": psnr, "max_abs": float(np.abs(a - b).max())}
    print(json.dumps(result))
    if args.threshold is not None and rmse > args.threshold:
        print(f"FAIL: rmse {rmse:.6f} > threshold {args.threshold}", file=sys.stderr)
        return 1
    return 0


def cmd_info(args) -> int:
    from cosig_tpu.accel.bvh import build_bvh
    from cosig_tpu.scene.tessellate import extract_triangles

    scene, _ = _load_scene_arg(args.scene)
    print(scene.summary())
    tris = extract_triangles(scene)
    print(f"tessellated triangles: {tris.count}")
    if tris.count:
        t0 = time.perf_counter()
        bvh = build_bvh(tris)
        dt = (time.perf_counter() - t0) * 1e3
        leaves = bvh.count[bvh.count > 0]
        print(
            f"BVH: {bvh.num_nodes} nodes, depth {bvh.depth()}, "
            f"{len(leaves)} leaves (max {leaves.max()} tris), built in {dt:.1f} ms"
        )
    return 0


def cmd_preset(args) -> int:
    from cosig_tpu.models.preset import ScenePreset
    from cosig_tpu.models.settings import RenderSettings

    if args.action == "save":
        preset = ScenePreset.from_render_settings(
            RenderSettings(), scene_file_path=args.scene
        )
        preset.PresetName = args.name
        preset.save(args.path)
        print(f"saved preset -> {args.path}")
    else:
        preset = ScenePreset.load(args.path)
        print(json.dumps(preset.__dict__, indent=2))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cosig-tpu", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("render", help="render a scene to PNG")
    _add_render_args(p)
    p.add_argument("--chunk-rows", type=int,
                   help="resumable chunked rendering with this many rows per chunk")
    p.add_argument("--checkpoint", help="checkpoint path for chunked rendering")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("turntable", help="360-degree turntable GIF")
    _add_render_args(p)
    p.add_argument("--steps", type=int, default=36)
    p.add_argument("--delay", type=int, default=15, help="centiseconds per frame")
    p.set_defaults(fn=cmd_turntable)

    p = sub.add_parser("preview", help="realtime preview loop with FPS readout")
    _add_render_args(p)
    p.add_argument("--frames", type=int, default=30)
    p.add_argument("--orbit", type=float, default=10.0, help="deg/frame camera Z orbit")
    p.add_argument("--save-dir")
    p.set_defaults(fn=cmd_preview)

    p = sub.add_parser("compare", help="RMSE/PSNR between two PNGs")
    p.add_argument("image_a")
    p.add_argument("image_b")
    p.add_argument("--threshold", type=float)
    p.set_defaults(fn=cmd_compare)

    p = sub.add_parser("info", help="scene + acceleration structure stats")
    p.add_argument("scene")
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("preset", help="save/load JSON presets")
    p.add_argument("action", choices=["save", "load"])
    p.add_argument("path")
    p.add_argument("--scene")
    p.add_argument("--name", default="Untitled")
    p.set_defaults(fn=cmd_preset)

    args = ap.parse_args(argv)
    from cosig_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
