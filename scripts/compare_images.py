"""Image comparison tool (the reference anticipates an external
``pbrt-compare`` reusing its test utilities — core/mod.rs:19-20).

Usage: python scripts/compare_images.py a.png b.png [--tolerance T]
Prints MSE / PSNR / max-abs-diff; exit 1 if max diff exceeds tolerance.
"""

import argparse
import sys
from pathlib import Path

import numpy as np


def load(path):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from pbrt_tpu.core.imageio import read_image

    img, _ = read_image(path)
    return np.asarray(img, dtype=np.float64)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--tolerance", type=float, default=0.0)
    args = ap.parse_args(argv)
    a = load(args.a)
    b = load(args.b)
    if a.shape != b.shape:
        print(f"size mismatch: {a.shape} vs {b.shape}")
        return 1
    diff = np.abs(a - b)
    mse = float((diff**2).mean())
    psnr = 10 * np.log10(1.0 / mse) if mse > 0 else float("inf")
    print(
        f"mse={mse:.6g} psnr={psnr:.2f}dB max_abs={diff.max():.6g} "
        f"mean_abs={diff.mean():.6g}"
    )
    return 0 if diff.max() <= args.tolerance or args.tolerance == 0.0 else 1


if __name__ == "__main__":
    sys.exit(main())
