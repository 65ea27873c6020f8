"""CLI entry point: ``python -m hyper_ray_tracer_tpu_torch``.

Keeps the reference's six flags and defaults (arguments.rs:21-47:
--width 1280 --height 720 --samples 100 --depth 10 --tile-size 80
--scene random) plus --output, --seed, --spp-chunk, --intersector,
--leaf-size, --verbosity and --cpu (the JAX package's CLI has the same
names and defaults).  The device
is CUDA; without a card the program stops with an error unless ``--cpu``
asks for the plain-PyTorch CPU path.
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
                             "cluster is not ported yet)")
    parser.add_argument("--leaf-size", type=int, default=4,
                        help="Primitives per BVH leaf (1-8)")
    parser.add_argument("--verbosity", type=int, default=2,
                        help="0=warn 1=info 2=debug (logger.rs:45-51)")
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

    log.info("Generating world...")
    scene = build_scene(args.scene)
    log.info("Generated world (%d primitives)", scene.static.n_prims)
    mode = resolve_intersector(scene, args.intersector)
    log.debug("Intersector: %s (%s)", mode, args.intersector)
    settings = RenderSettings(width=args.width, height=args.height,
                              samples=args.samples, depth=args.depth,
                              seed=args.seed, spp_chunk=args.spp_chunk,
                              intersector=mode, leaf_size=args.leaf_size)
    t0 = time.monotonic()
    img = render_image(scene, settings, device)
    dt = time.monotonic() - t0

    out = args.output or f"{args.scene}.png"
    write_png(out, img)
    # Completion summary, mirroring application.rs:266-277.
    minutes, seconds = divmod(int(dt), 60)
    log.info("Rendering finished in %02d:%02d", minutes, seconds)
    log.info("Image Info - Width: %d, Height: %d, Samples: %d, "
             "Depth: %d, Objects: %d", settings.width, settings.height,
             settings.samples, settings.depth, scene.static.n_prims)
    log.info("wrote %s", out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
