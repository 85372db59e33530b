"""``tpurecon`` — surface reconstruction CLI, counterpart of the
reference ``bin/recon`` (src/mesh/recon.cc: scans → Poisson → .obj)
and ``bin/scan2tsdf``+``vdb2mesh`` (src/tsdf/): scans → TSDF fusion →
mesh.

    python -m tpu3dtk.cli.recon -m 2500 -r 15 --method imls -o out.obj dir/
    python -m tpu3dtk.cli.recon --method tsdf --voxel 8 -o out.ply dir/
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpurecon",
        description="surface reconstruction (3DTK mesh/tsdf)",
    )
    p.add_argument("dir")
    p.add_argument("-s", "--start", type=int, default=0)
    p.add_argument("-e", "--end", type=int, default=-1)
    p.add_argument("-f", "--format", default="uos")
    p.add_argument("-m", "--max", type=float, default=-1, dest="max_range")
    p.add_argument("-r", "--reduce", type=float, default=-1.0)
    p.add_argument("-O", "--octree", type=int, default=1)
    p.add_argument("--method", choices=("imls", "poisson", "tsdf"), default="imls")
    p.add_argument("--voxel", type=float, default=10.0)
    p.add_argument("--trunc", type=float, default=-1.0,
                   help="tsdf truncation (default 3*voxel)")
    p.add_argument("-K", "--knearest", type=int, default=12)
    p.add_argument("-o", "--out", default="mesh.obj",
                   help=".obj or .ply output path")
    p.add_argument("-q", "--quiet", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from ..core import math3d
    from ..core.scan import TPUScan
    from ..io import frames as frames_io
    from ..io.meshio import write_obj, write_ply_mesh
    from ..io.scandir import PointFilter, read_scan_dir

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
        fp = frames_io.frames_path(args.dir, s.identifier)
        if os.path.exists(fp):
            s.set_pose(np.asarray(frames_io.final_pose(fp)), 2, record=False)
        scans.append(s)
    if not scans:
        print(f"no scans found in {args.dir}", file=sys.stderr)
        return 1

    if args.method == "tsdf":
        from ..models.tsdf import TsdfParams, TsdfVolume

        allg = np.concatenate(
            [
                np.asarray(math3d.transform3(s.transMat, s.reduced_local()))
                for s in scans
            ]
        )
        trunc = args.trunc if args.trunc > 0 else 3 * args.voxel
        vol = TsdfVolume.for_bounds(
            allg.min(0), allg.max(0),
            TsdfParams(voxel=args.voxel, truncation=trunc),
        )
        for s in scans:
            vol.integrate(np.asarray(s.reduced_local()), s.transMat)
            if not args.quiet:
                print(f"fused scan {s.identifier}")
        verts, faces = vol.extract_mesh()
    elif args.method == "poisson":
        from ..models.mesh import PoissonParams, reconstruct_poisson

        allg = np.concatenate(
            [
                np.asarray(math3d.transform3(s.transMat, s.reduced_local()))
                for s in scans
            ]
        )
        verts, faces = reconstruct_poisson(allg, None, PoissonParams())
    else:
        from ..models.mesh import MeshParams, reconstruct_imls

        allg = np.concatenate(
            [
                np.asarray(math3d.transform3(s.transMat, s.reduced_local()))
                for s in scans
            ]
        )
        verts, faces = reconstruct_imls(
            allg, None, MeshParams(voxel=args.voxel, k=args.knearest)
        )
    if args.out.endswith(".ply"):
        write_ply_mesh(args.out, verts, faces)
    else:
        write_obj(args.out, verts, faces)
    print(f"{len(verts)} vertices, {len(faces)} triangles -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
