"""``tpuplanes`` — plane detection CLI, counterpart of the reference
``bin/planes`` (src/shapes/planes.cc: Hough plane extraction, writes
``planes/plane###.n`` normal files + ``planes.list``)."""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpuplanes", description="Hough plane detection (3DTK planes)"
    )
    p.add_argument("dir")
    p.add_argument("-s", "--start", type=int, default=0)
    p.add_argument("-f", "--format", default="uos")
    p.add_argument("-m", "--max", type=float, default=-1, dest="max_range")
    p.add_argument("-r", "--reduce", type=float, default=-1.0)
    p.add_argument("-O", "--octree", type=int, default=1)
    p.add_argument(
        "-p", "--plane-algo", choices=("sht", "rht"), default="rht",
        help="standard or randomized Hough (ref -p)",
    )
    p.add_argument("--min-inliers", type=int, default=200)
    p.add_argument("--max-planes", type=int, default=20)
    p.add_argument("--dist-tol", type=float, default=10.0)
    p.add_argument(
        "-C", "--config", default=None,
        help="ConfigFileHough key-value file (ref bin/hough.cfg,"
        " src/shapes/ConfigFileHough.cc); explicit flags override it",
    )
    p.add_argument("-o", "--out", default="planes")
    p.add_argument("-q", "--quiet", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from ..core.scan import TPUScan
    from ..io.scandir import PointFilter, read_scan_dir
    from ..models.shapes import (
        HoughParams, detect_planes, detect_planes_rht,
    )

    cfg = None
    if args.config:
        from ..io.hough_config import load_hough_config

        cfg = load_hough_config(args.config)
    # -m wins; else the config's MaxDist (ConfigFileHough semantics)
    range_max = args.max_range if args.max_range > 0 else (
        cfg["MaxDist"] if cfg and cfg["MaxDist"] > 0 else None
    )
    pf = PointFilter(range_max=range_max)
    scans = list(
        read_scan_dir(
            args.dir, format=args.format, start=args.start,
            end=args.start, point_filter=pf,
        )
    )
    if not scans:
        print(f"no scan {args.start} in {args.dir}", file=sys.stderr)
        return 1
    s = TPUScan.from_raw(scans[0])
    s.set_reduction(args.reduce, args.octree if args.reduce > 0 else 0)
    pts = np.asarray(s.reduced_local())
    if cfg is not None:
        from ..io.hough_config import hough_params_from_config

        hp = hough_params_from_config(cfg)
        import dataclasses as _dc

        overrides = {}
        if "--min-inliers" in (argv or sys.argv):
            overrides["min_inliers"] = args.min_inliers
        if "--max-planes" in (argv or sys.argv):
            overrides["max_planes"] = args.max_planes
        if "--dist-tol" in (argv or sys.argv):
            overrides["dist_tol"] = args.dist_tol
        if overrides:
            hp = _dc.replace(hp, **overrides)
    else:
        hp = HoughParams(
            min_inliers=args.min_inliers, max_planes=args.max_planes,
            dist_tol=args.dist_tol,
        )
    fn = detect_planes_rht if args.plane_algo == "rht" else detect_planes
    planes = fn(pts, hp)
    os.makedirs(args.out, exist_ok=True)
    listing = os.path.join(args.out, "planes.list")
    with open(listing, "w") as lst:
        for k, pl in enumerate(planes):
            path = os.path.join(args.out, f"plane{k:03d}.n")
            with open(path, "w") as f:
                f.write(f"{pl.normal[0]} {pl.normal[1]} {pl.normal[2]}\n")
                f.write(f"{pl.rho}\n")
                f.write(f"{pl.center[0]} {pl.center[1]} {pl.center[2]}\n")
                f.write(f"{pl.n_inliers}\n")
            lst.write(f"{path}\n")
            if not args.quiet:
                print(
                    f"plane {k}: n=({pl.normal[0]:.3f},{pl.normal[1]:.3f},"
                    f"{pl.normal[2]:.3f}) rho={pl.rho:.1f} "
                    f"inliers={pl.n_inliers}"
                )
    print(f"{len(planes)} planes -> {listing}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
