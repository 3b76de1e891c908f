"""GPU smoke check: the renderer's main path, end to end, on one card.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python chip_smoke.py               # phases 1-4 on one card
    python chip_smoke.py --four-cards  # phase 5 only: frame sharding on 4

Phases (each checks its results against the tolerance it prints):

0. device check: refuse to run unless JAX's default backend is a GPU;
   print the card's name and power limit; place the compile cache.
1. ``glass_sphere`` at full size (1024^2, depth 6, 4x AA, brute-force
   closest hit) through ``Renderer.render_to_device``.
2. ``large_mesh`` at full size (2048^2, depth 4, 11,970 triangles, so the
   per-ray BVH walk).
3. the CLI, in this process (a second process could not open the card):
   render, analytic render, debug render, turntable, preview.
4. correctness on the card: every generated config at 128^2, plus one
   with soft shadows, glossy, motion blur and analytic primitives, each
   rendered on the GPU and on the host CPU by the same code; the hash RNG
   against numpy float32; the BVH walk against brute force.
5. ``--four-cards``: ``render_sharded`` over 4 cards against the one-card
   render at ``glass_sphere`` full size.

Exits non-zero, printing no result line, if any phase fails. The last
line of a passing run is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = pathlib.Path(__file__).resolve().parent

# Phase 4 tolerances, GPU render vs CPU render of the same code. The GPU
# may contract mul+add into FMA, which moves silhouette tie-breaks, and
# the hash RNG amplifies last-bit differences through frac().
RMSE_MAX = 1e-3
BIG_DIFF = 0.07
BIG_DIFF_SHARE_MAX = 0.005
# BVH walk vs brute force (tests/test_bvh.py): pixels off by more than
# 1e-3 (near-first traversal breaks equal-t ties differently).
BVH_DIFF = 1e-3
BVH_DIFF_SHARE_MAX = 0.005
# Hash RNG vs numpy float32: frac() of a product that reaches ~2e4 turns
# one-ulp differences (FMA contraction) into ~2e-3; an output must stay
# within this many ulps of the value frac() was taken of.
HASH_ULPS = 16
# Sharded vs one-card render (tests/test_sharding.py).
SHARD_MAX_ABS = 5e-4


class PhaseFailed(AssertionError):
    pass


def say(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    say(f"  check {'ok  ' if ok else 'FAIL'} {what}")
    if not ok:
        raise PhaseFailed(what)


def image_diff(a, b) -> dict:
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    per_px = np.abs(a - b).max(axis=-1)
    return {
        "rmse": float(np.sqrt(((a - b) ** 2).mean())),
        "max_abs": float(per_px.max()),
        f"share_over_{BIG_DIFF}": float((per_px > BIG_DIFF).mean()),
        f"share_over_{BVH_DIFF}": float((per_px > BVH_DIFF).mean()),
    }


# ---------------------------------------------------------------------------
# Phases 1 and 2: full-size frames through Renderer.render_to_device.


def phase_full_size(name: str, resolution: int | None = None, repeats: int = 5) -> None:
    from bench import bench_config

    r = bench_config(name, repeats=repeats, resolution=resolution)
    w, h = r["resolution"]
    say(
        f"  {name} {w}x{h} depth {r['max_depth']} aa {r['aa']} "
        f"{r['triangles']} tris: compile+first frame {r['compile_s']:.3f} s, "
        f"median {r['ms_per_frame']:.3f} ms/frame over {r['frames_timed']} "
        f"(frames {', '.join(f'{t:.3f}' for t in r['frame_ms'])} ms), "
        f"{r['rays_traced']} live rays/frame = {r['mrays_per_s']:.3f} Mrays/s, "
        f"peak_bytes_in_use {r['peak_bytes_in_use']}"
    )
    check(r["image_finite"], "image is finite")
    check(r["image_min"] >= 0.0, f"image min {r['image_min']} >= 0")
    samples = w * h * r["aa"]
    hi = samples * r["max_depth"] * (1 + r["lights"])
    check(
        samples <= r["rays_traced"] <= hi,
        f"live rays {r['rays_traced']} within [{samples}, {hi}] "
        "(one primary per sample .. every bounce and shadow ray)",
    )


# ---------------------------------------------------------------------------
# Phase 3: the CLI in-process.


def phase_cli(size: int | None = None, frames: int = 5) -> None:
    from cosig_tpu.cli import main as cli
    from cosig_tpu.utils.gif import decode_gif_frame_count
    from cosig_tpu.utils.png import read_png

    cornell = str(ROOT / "scenes" / "demo_cornell.txt")
    res = ["--width", str(size), "--height", str(size)] if size else []
    with tempfile.TemporaryDirectory() as tmp:

        def run(argv, what):
            t0 = time.perf_counter()
            rc = cli(argv)
            say(f"  cosig-tpu {' '.join(argv[:2])} ... -> rc {rc} in "
                f"{time.perf_counter() - t0:.3f} s")
            check(rc == 0, f"{what} exits 0")

        out = f"{tmp}/cornell.png"
        run(["render", cornell, "-o", out, *res], "render demo_cornell")
        img = read_png(out)
        check(img.shape == (size or 384, size or 384, 3), "cornell PNG shape")
        check(float(img.std()) > 5.0, f"cornell PNG has content (8-bit std {img.std():.1f} > 5)")

        out = f"{tmp}/walls.png"
        run(["render", "generated:cosig_walls", "--analytic", "-o", out, *res],
            "render --analytic")
        check(read_png(out).shape == (size or 512, size or 512, 3), "walls PNG shape")

        out = f"{tmp}/normals.png"
        run(["render", cornell, "--debug-mode", "2", "-o", out, *res],
            "render --debug-mode 2")
        check(read_png(out).shape[:2] == (size or 384, size or 384), "normals PNG shape")

        out = f"{tmp}/turn.gif"
        run(["turntable", cornell, "--steps", "3", "-o", out, *res], "turntable")
        check(decode_gif_frame_count(out) == 3, "turntable GIF has 3 frames")

        run(["preview", cornell, "--frames", str(frames), "--save-dir", tmp, *res],
            "preview")
        check(pathlib.Path(f"{tmp}/frame_{frames - 1:04d}.png").exists(),
              f"preview saved {frames} frames")


# ---------------------------------------------------------------------------
# Phase 4: correctness on the card.


def _correctness_cases(res: int):
    from cosig_tpu.scene.generate import CONFIGS

    for name, make in CONFIGS.items():
        scene, st = make()
        yield name, scene, st.replace(resolution_override=(res, res))
    scene, st = CONFIGS["glass_sphere"]()
    yield "glass_sphere+effects+analytic", scene, st.replace(
        resolution_override=(res, res),
        enable_soft_shadows=True, light_size=5.0,
        enable_glossy=True, surface_roughness=0.05,
        enable_motion_blur=True, shutter_speed=0.5,
        analytic_primitives=True,
    )


def _render_on(device, scene, settings, backend="auto"):
    import jax
    import numpy as np

    from cosig_tpu.render.renderer import Renderer

    with jax.default_device(device):
        img = Renderer(backend=backend).render_to_device(scene, settings)
    got = img.devices()
    if got != {device}:
        raise PhaseFailed(f"render ran on {got}, expected {device}")
    return np.asarray(img)


def _hash33_numpy(x, y, z):
    """Independent numpy float32 transcription of Hash33 (compute:116-121)
    -> (outputs, the values frac() was taken of)."""
    import numpy as np

    f = np.float32

    def frac(v):
        return (v - np.floor(v)).astype(f)

    x, y, z = frac(x * f(0.1031)), frac(y * f(0.1030)), frac(z * f(0.0973))
    d = (x * (y + f(33.33)) + y * (x + f(33.33)) + z * (z + f(33.33))).astype(f)
    x, y, z = x + d, y + d, z + d
    pre = ((x + y) * z, (x + x) * y, (y + x) * x)
    return tuple(frac(v) for v in pre), pre


def phase_correctness(res: int = 128, bvh_res: int = 256, hash_n: int = 512) -> None:
    import jax
    import numpy as np

    from cosig_tpu.ops import rng
    from cosig_tpu.scene.generate import CONFIGS

    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    say(f"  tolerance: RMSE <= {RMSE_MAX}, share of pixels off by > {BIG_DIFF} "
        f"<= {BIG_DIFF_SHARE_MAX}")
    failures = []
    for name, scene, st in _correctness_cases(res):
        try:
            a = _render_on(gpu, scene, st)
            b = _render_on(cpu, scene, st)
        except Exception:  # report the case, go on with the others
            traceback.print_exc()
            say(f"  FAIL {name} {res}x{res}: render raised")
            failures.append(name)
            continue
        d = image_diff(a, b)
        ok = (np.isfinite(a).all() and d["rmse"] <= RMSE_MAX
              and d[f"share_over_{BIG_DIFF}"] <= BIG_DIFF_SHARE_MAX)
        say(f"  {'ok  ' if ok else 'FAIL'} {name} {res}x{res} gpu vs cpu: "
            + ", ".join(f"{k} {v:.6g}" for k, v in d.items()))
        if not ok:
            failures.append(name)

    # Hash33 on the card vs numpy float32.
    g = np.arange(hash_n, dtype=np.float32)
    px, py = np.meshgrid(g, g + np.float32(0.5), indexing="ij")
    pz = (px * np.float32(0.37) + py).astype(np.float32)
    got = jax.jit(rng.hash33)(*(jax.device_put(v, gpu) for v in (px, py, pz)))
    want, pre = _hash33_numpy(px, py, pz)
    err = np.stack([np.abs(np.asarray(u) - w) for u, w in zip(got, want)])
    err = np.minimum(err, 1.0 - err)  # frac wraps 1 - e next to 0
    ulps = err / np.spacing(np.abs(np.stack(pre)))
    exact = float((err != 0).mean())
    ok = float(ulps.max()) <= HASH_ULPS
    say(f"  {'ok  ' if ok else 'FAIL'} hash33 {hash_n}^2 gpu vs numpy float32: "
        f"share not bit-equal {exact:.3g}, max abs {float(err.max()):.3g}, "
        f"max {float(ulps.max()):.3g} ulps of the pre-frac value (<= {HASH_ULPS})")
    if not ok:
        failures.append("hash33")

    # BVH walk vs brute force on large_mesh.
    scene, st = CONFIGS["large_mesh"]()
    st = st.replace(resolution_override=(bvh_res, bvh_res))
    walk = _render_on(gpu, scene, st, backend="xla")
    brute = _render_on(gpu, scene, st, backend="xla-brute")
    d = image_diff(walk, brute)
    ok = d[f"share_over_{BVH_DIFF}"] < BVH_DIFF_SHARE_MAX
    say(f"  {'ok  ' if ok else 'FAIL'} large_mesh {bvh_res}x{bvh_res} BVH walk vs "
        f"brute force on gpu (share off by > {BVH_DIFF} < {BVH_DIFF_SHARE_MAX}): "
        + ", ".join(f"{k} {v:.6g}" for k, v in d.items()))
    if not ok:
        failures.append("bvh_vs_brute")
    check(not failures, f"all correctness cases within tolerance (failed: {failures})")


# ---------------------------------------------------------------------------
# Phase 5: frame sharding over four cards.


def phase_four_cards(resolution: int | None = None, repeats: int = 3) -> None:
    import jax
    import numpy as np

    from cosig_tpu.models.soa import compile_scene, frame_params, static_config
    from cosig_tpu.ops import trace_xla
    from cosig_tpu.parallel.sharding import make_mesh, render_sharded_jit
    from cosig_tpu.scene.generate import CONFIGS

    check(len(jax.devices()) >= 4, f"{len(jax.devices())} devices >= 4")
    scene, st = CONFIGS["glass_sphere"]()
    if resolution is not None:
        st = st.replace(resolution_override=(resolution, resolution))
    arrays = compile_scene(scene)
    params = frame_params(scene, st)
    cfg = static_config(scene, st)
    mesh = make_mesh(4)

    def timed(fn):
        t0 = time.perf_counter()
        img = fn().block_until_ready()
        first = time.perf_counter() - t0
        ms = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            img = fn().block_until_ready()
            ms.append((time.perf_counter() - t0) * 1e3)
        return np.asarray(img), first, ms

    one, one_first, one_ms = timed(lambda: trace_xla.render_jit(arrays, params, cfg))
    four, four_first, four_ms = timed(
        lambda: render_sharded_jit(arrays, params, cfg, mesh)
    )
    for label, first, ms in (("one card", one_first, one_ms),
                             ("four cards", four_first, four_ms)):
        say(f"  glass_sphere {cfg.width}x{cfg.height} {label}: compile+first frame "
            f"{first:.3f} s, median {sorted(ms)[len(ms) // 2]:.3f} ms/frame "
            f"(frames {', '.join(f'{t:.3f}' for t in ms)} ms)")
    err = float(np.abs(four - one).max())
    check(four.shape == one.shape, f"sharded shape {four.shape} == {one.shape}")
    check(err <= SHARD_MAX_ABS, f"max |sharded - one card| {err:.3g} <= {SHARD_MAX_ABS}")


# ---------------------------------------------------------------------------


def run_phases(phases) -> list:
    failed = []
    for label, fn in phases:
        say(f"phase {label}")
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:  # report every phase, then fail the run below
            traceback.print_exc()
            failed.append(label)
            say(f"phase {label}: FAILED after {time.perf_counter() - t0:.1f} s")
        else:
            say(f"phase {label}: passed in {time.perf_counter() - t0:.1f} s")
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card sharding phase")
    args = ap.parse_args(argv)

    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        print(f"chip_smoke: JAX found no GPU (default backend {backend!r})",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        print(f"chip_smoke: nvidia-smi failed: {smi.stderr}", file=sys.stderr)
        return 1
    say(smi.stdout.strip())

    from cosig_tpu.utils.compile_cache import enable_compile_cache

    say(f"compile cache: {enable_compile_cache()}")
    dev = jax.devices()[0]
    say(f"jax {jax.__version__}: {len(jax.devices())} x {dev.device_kind}")

    if args.four_cards:
        phases = [("5 four cards", phase_four_cards)]
    else:
        phases = [
            ("1 glass_sphere full size", lambda: phase_full_size("glass_sphere")),
            ("2 large_mesh full size", lambda: phase_full_size("large_mesh")),
            ("3 cli", phase_cli),
            ("4 correctness", phase_correctness),
        ]
    failed = run_phases(phases)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
