"""Command-line driver (reference: src/bin/pbrt.rs:24-85).

Flags mirror the reference: -n/--nthreads (accepted for compatibility;
parallelism comes from the device mesh), --quick, -q/--quiet,
-v/--verbose, -o/--outfile, positional scene files.  Verbosity maps to
logging levels like bin/pbrt.rs:48-57; parse errors exit(1)
(bin/pbrt.rs:76-78).
"""

from __future__ import annotations

import argparse
import logging
import sys

from pbrt_tpu import Options
from pbrt_tpu.core.api import PbrtAPI
from pbrt_tpu.core.parser import ParseError


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="pbrt-tpu", description="JAX pbrt renderer"
    )
    ap.add_argument("-n", "--nthreads", type=int, default=1,
                    help="accepted for pbrt compatibility (mesh controls parallelism)")
    ap.add_argument("--quick", action="store_true", help="quarter-resolution, quarter-spp draft render")
    ap.add_argument("-q", "--quiet", action="store_true")
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("-o", "--outfile", default="", help="override output image path")
    ap.add_argument("--ray-batch", type=int, default=1 << 16)
    ap.add_argument("--checkpoint", default="", metavar="DIR",
                    help="save film state + sweep cursor to DIR periodically "
                         "and resume from it if present")
    ap.add_argument("scenes", nargs="+", help="pbrt scene files")
    args = ap.parse_args(argv)

    level = logging.INFO
    if args.verbose:
        level = logging.DEBUG
    if args.quiet:
        level = logging.ERROR
    logging.basicConfig(
        level=level, format="%(asctime)s.%(msecs)03d %(levelname)s %(message)s",
        datefmt="%H:%M:%S",
    )

    opts = Options(
        num_threads=args.nthreads,
        quick_render=args.quick,
        quiet=args.quiet,
        verbose=args.verbose,
        image_file=args.outfile,
        ray_batch=args.ray_batch,
        checkpoint_dir=args.checkpoint or None,
    )
    pbrt = PbrtAPI(opts)
    pbrt.init()
    for f in args.scenes:
        try:
            pbrt.parse_file(f)
        except (ParseError, OSError) as e:
            logging.error("%s: %s", f, e)
            return 1
    pbrt.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
