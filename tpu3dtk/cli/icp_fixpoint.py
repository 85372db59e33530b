"""``tpuicpfixpoint`` — reduced-precision ICP driver, counterpart of
the reference ``bin/icpFixpoint`` (src/slam6d/icpFixpoint.cc):
sequential matching through the quantized datapath
(models.sc_fixed: bf16 ranking, 10^-exp epsilon) with a
per-scan comparison against the exact-f32 pipeline.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpuicpfixpoint",
        description="reduced-precision (bf16) sequential ICP (3DTK icpFixpoint)",
    )
    p.add_argument("dir")
    p.add_argument("-s", "--start", type=int, default=0)
    p.add_argument("-e", "--end", type=int, default=-1)
    p.add_argument("-f", "--format", default="uos")
    p.add_argument("-m", "--max", type=float, default=-1, dest="max_range")
    p.add_argument("-r", "--reduce", type=float, default=-1.0)
    p.add_argument("-O", "--octree", type=int, default=1)
    p.add_argument("-d", "--dist", type=float, default=25.0)
    p.add_argument("-i", "--iter", type=int, default=50)
    p.add_argument(
        "--epsExp", type=int, default=3,
        help="epsilon = 10^-exp termination (ref epsilonICPexp)",
    )
    p.add_argument(
        "--compare", action="store_true",
        help="also run the exact pipeline and report pose deltas",
    )
    p.add_argument("--frames-out", default=None)
    p.add_argument("-q", "--quiet", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import jax.numpy as jnp

    from ..core.scan import TPUScan
    from ..io import frames as frames_io
    from ..io.frames import AlgoType
    from ..io.scandir import PointFilter, read_scan_dir
    from ..models.sc_fixed import compare_fixed_float, icp_pair_fixed

    pf = PointFilter(
        range_max=args.max_range if args.max_range > 0 else None
    )
    scans = []
    for raw in read_scan_dir(
        args.dir, format=args.format, start=args.start, end=args.end,
        point_filter=pf,
    ):
        s = TPUScan.from_raw(raw)
        s.set_reduction(args.reduce, args.octree if args.reduce > 0 else 0)
        scans.append(s)
    if len(scans) < 2:
        print("need at least two scans", file=sys.stderr)
        return 1

    cap = max(len(s.reduced_local()) for s in scans)
    cap = ((cap + 511) // 512) * 512
    md2 = args.dist**2
    from ..core import math3d

    for i in range(1, len(scans)):
        prev, cur = scans[i - 1], scans[i]
        model = np.asarray(
            math3d.transform3(prev.transMat, prev.reduced_local())
        ).astype(np.float32)
        target = np.asarray(cur.reduced_local(), np.float32)
        mp = np.zeros((cap, 3), np.float32)
        mp[: len(model)] = model
        mm = np.zeros(cap, bool)
        mm[: len(model)] = True
        tp = np.zeros((cap, 3), np.float32)
        tp[: len(target)] = target
        tm = np.zeros(cap, bool)
        tm[: len(target)] = True
        res = icp_pair_fixed(
            jnp.asarray(mp), jnp.asarray(mm), jnp.asarray(tp),
            jnp.asarray(tm), jnp.asarray(cur.transMat, jnp.float32),
            md2, max_iterations=args.iter, eps_exp=args.epsExp,
        )
        T = np.asarray(res.T, np.float64)
        u, _, vt = np.linalg.svd(T[:3, :3])
        T[:3, :3] = u @ vt
        if args.compare:
            cmpres = compare_fixed_float(
                mp, tp, cur.transMat.astype(np.float32), md2,
                max_iterations=args.iter, eps_exp=args.epsExp,
            )
            if not args.quiet:
                print(
                    f"scan {cur.identifier}: bf16-vs-f32 delta "
                    f"{cmpres['delta_translation_cm']:.4f} cm"
                )
        cur.set_pose(T, AlgoType.ICP)
        if not args.quiet:
            print(
                f"scan {cur.identifier}: ITER {int(res.iterations)} "
                f"err {float(res.error):.4f} pairs {int(res.n_pairs)}"
            )

    out_dir = args.frames_out or args.dir
    for s in scans:
        if not s.frames:
            s.add_frame(AlgoType.ICP)
        mats = np.stack([f[0] for f in s.frames])
        types = [f[1] for f in s.frames]
        frames_io.write_frames(
            frames_io.frames_path(out_dir, s.identifier), mats, types
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
