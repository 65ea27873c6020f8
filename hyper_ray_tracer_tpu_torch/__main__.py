"""CLI entry point: ``python -m hyper_ray_tracer_tpu_torch``.

Keeps the reference's six flags and defaults (arguments.rs:21-47:
--width 1280 --height 720 --samples 100 --depth 10 --tile-size 80
--scene random) plus the JAX package's CLI extras under the same names
and defaults: --output, --seed, --spp-chunk, --intersector, --leaf-size,
--checkpoint, --preview, --profile, --watch, --verbosity, --no-partition,
--cpu, and --no-bvh (deprecated, kept for old command lines).
--no-partition runs every bounce's sweep plain; by default the sweep
partitions the bounces where it pays (``RenderSettings.partition``), and
the PNG is byte-identical either way.  The device is CUDA; without a
card the program stops with an error unless ``--cpu`` asks for the
plain-PyTorch CPU path.
"""

from __future__ import annotations

import argparse
import sys
import time

from .models.builders import SCENES


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="hyper_ray_tracer_tpu_torch",
        description="Monte-Carlo path tracer (PyTorch/CUDA port)",
    )
    # Reference flags (arguments.rs:24-46).
    parser.add_argument("--width", type=int, default=1280,
                        help="Width of the image")
    parser.add_argument("--height", type=int, default=720,
                        help="Height of the image")
    parser.add_argument("--samples", type=int, default=100,
                        help="Samples per pixel")
    parser.add_argument("--depth", type=int, default=10, help="Max depth")
    parser.add_argument("--tile-size", type=int, default=80,
                        help="Accepted for reference-CLI parity; sample "
                             "chunking replaces tiles (see --spp-chunk)")
    parser.add_argument("--scene", choices=sorted(SCENES), default="random")
    parser.add_argument("--output", default=None,
                        help="Output PNG path (default: <scene>.png)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--spp-chunk", type=int, default=None,
                        help="Samples per device pass (default: auto)")
    parser.add_argument("--intersector", default="auto",
                        choices=["auto", "sweep", "cluster", "bvh"],
                        help="Intersector mode (auto: the all-pairs sweep "
                             "below 30,000 primitives, the BVH from there; "
                             "cluster: the box-culled sweep of spatial "
                             "clusters)")
    parser.add_argument("--no-bvh", action="store_true",
                        help="Deprecated, and does nothing: auto picks the "
                             "mode (--intersector sweep forces the sweeps)")
    parser.add_argument("--no-partition", action="store_true",
                        help="Run every bounce's sweep plain.  By default "
                             "the sweep mode partitions a scene's large "
                             "primitive groups where that skips enough "
                             "pairs; the image is bit-identical either "
                             "way")
    parser.add_argument("--leaf-size", type=int, default=4,
                        help="Primitives per BVH leaf (1-8)")
    parser.add_argument("--checkpoint", default=None,
                        help="Checkpoint file; resumes if it exists")
    parser.add_argument("--preview", default=None,
                        help="Progressive preview PNG, rewritten at every "
                             "snapshot (every chunk, at least 8 times)")
    parser.add_argument("--verbosity", type=int, default=2,
                        help="0=warn 1=info 2=debug (logger.rs:45-51)")
    parser.add_argument("--profile", default=None, metavar="LOGDIR",
                        help="Capture a torch.profiler trace of the render "
                             "into LOGDIR (Chrome trace, TensorBoard-"
                             "compatible)")
    parser.add_argument("--watch", default=None, metavar="PARAMS.json",
                        help="Watch-mode re-render: after each render, "
                             "poll PARAMS.json (a JSON object of CLI "
                             "overrides: width/height/samples/depth/"
                             "scene/seed/spp_chunk) and re-render "
                             "whenever it changes, the headless analogue "
                             "of the reference viewer's resize-triggered "
                             "re-render (application.rs:334-355).  "
                             "Ctrl-C exits.")
    parser.add_argument("--cpu", action="store_true",
                        help="Render on the CPU with the plain-PyTorch "
                             "versions of the kernels")
    args = parser.parse_args(argv)

    import torch

    from . import build_scene
    from .render import RenderSettings, render_image, resolve_intersector
    from .utils.image import write_png
    from .utils.logging import init as log_init

    log = log_init(args.verbosity)
    if args.cpu:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda")
    else:
        raise RuntimeError(
            "no CUDA device is available; pass --cpu to render on the CPU "
            "with the plain-PyTorch versions of the kernels")

    if args.no_bvh:
        log.warning("--no-bvh is deprecated and does nothing; "
                    "--intersector sweep forces the sweeps")

    log.info("Generating world...")
    scene = build_scene(args.scene)
    log.info("Generated world (%d primitives)", scene.static.n_prims)

    overrides = {}

    def render_once():
        nonlocal scene
        eff = {**vars(args), **overrides}
        if eff["scene"] != scene.name:
            log.info("Generating world...")
            scene = build_scene(eff["scene"])
            log.info("Generated world (%d primitives)",
                     scene.static.n_prims)
        mode = resolve_intersector(scene, args.intersector)
        log.debug("Intersector: %s (%s)", mode, args.intersector)
        settings = RenderSettings(
            width=eff["width"], height=eff["height"],
            samples=eff["samples"], depth=eff["depth"], seed=eff["seed"],
            spp_chunk=eff["spp_chunk"], intersector=mode,
            leaf_size=args.leaf_size, checkpoint_path=args.checkpoint,
            preview_path=args.preview, partition=not args.no_partition)
        t0 = time.monotonic()

        def progress(done, total):
            log.info("progress: %d/%d spp (%.1fs)", done, total,
                     time.monotonic() - t0)

        if args.profile:
            from .utils.profiling import trace

            with trace(args.profile):
                img = render_image(scene, settings, device, progress)
        else:
            img = render_image(scene, settings, device, progress)
        dt = time.monotonic() - t0

        out = args.output or f"{eff['scene']}.png"
        write_png(out, img)
        # Completion summary, mirroring application.rs:266-277.
        minutes, seconds = divmod(int(dt), 60)
        log.info("Rendering finished in %02d:%02d", minutes, seconds)
        log.info("Image Info - Width: %d, Height: %d, Samples: %d, "
                 "Depth: %d, Objects: %d", settings.width, settings.height,
                 settings.samples, settings.depth, scene.static.n_prims)
        log.info("wrote %s", out)

    render_once()
    if not args.watch:
        return 0

    # Watch mode: re-render whenever the params file changes (the
    # reference re-renders on every window resize, application.rs:334-355).
    # Each render completes, then the newest params win.
    from .utils.watch import watch_loop

    def on_change(new_overrides):
        nonlocal overrides
        overrides = new_overrides
        render_once()

    log.info("watching %s for changes (Ctrl-C to stop)", args.watch)
    watch_loop(args.watch, on_change, log=log)
    return 0


if __name__ == "__main__":
    sys.exit(main())
