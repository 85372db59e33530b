"""``tpuslam`` — drop-in style CLI mirroring the reference ``slam6D``
driver's core flags (ref src/slam6d/slam6D.cc:158-367 option table) so
published invocations (README.md:66-103) translate directly.

Implemented flags (same letters/longs as the reference):
  -s/--start -e/--end  scan range
  -f/--format          scan format (uos, uosr, xyz, ...)
  -m/--max -M/--min    range filters (cm)
  -r/--reduce          octree/voxel reduction voxel size
  -O/--octree          pts per voxel for randomized reduction
  -R/--random          per-iteration random point subsampling
  -d/--dist            ICP max match distance (cm)
  -i/--iter            max ICP iterations
  --epsICP             ICP convergence epsilon
  -a/--algo            minimizer 1=quat 2=svd 3=ortho 6=apx
  --metascan           match against union of previous scans
  -G/--graphSlam6DAlgo 1 enables LUM GraphSLAM relaxation
  -I/--iterSLAM        max LUM outer iterations
  -D/--distSLAM        max match distance for LUM (cm)
  --epsSLAM            LUM convergence epsilon
  -L/--loop6DAlgo      ELCH loop closure: 1 euler, 2 quat, 3 unitQuat, 4 slerp
  --cldist             loop-closing distance
  --loopsize           min scans between loop ends
  --exportAllPoints    write registered cloud points.pts
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


ALGO_NAMES = {
    1: "quat", 2: "svd", 3: "ortho", 4: "dual", 5: "helix",
    6: "apx", 7: "lumeuler", 8: "lumquat", 9: "quatscale", 10: "napx",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpuslam",
        description="6D SLAM on JAX (capabilities of 3DTK slam6D)",
    )
    p.add_argument("dir", help="scan directory")
    p.add_argument("-s", "--start", type=int, default=0)
    p.add_argument("-e", "--end", type=int, default=-1)
    p.add_argument("-f", "--format", default="uos")
    p.add_argument("-m", "--max", type=float, default=-1, dest="max_range")
    p.add_argument("-M", "--min", type=float, default=-1, dest="min_range")
    p.add_argument(
        "-u", "--customFilter", default=None, dest="custom_filter",
        help="custom point-filter DSL '{mode};{n}[;params...]/...' "
        "(ref pointfilter.cc CheckerCustom modes 0/1/2/10/11/20/21/22)",
    )
    p.add_argument(
        "--scans", default=None,
        help="scan range-set DSL 'a:b,c:step:d,$' (ref scan_settings "
        "range parser); overrides -s/-e",
    )
    p.add_argument("-r", "--reduce", type=float, default=-1.0)
    p.add_argument("-O", "--octree", type=int, default=1)
    p.add_argument("-R", "--random", type=int, default=-1)
    p.add_argument("-d", "--dist", type=float, default=25.0)
    p.add_argument("-i", "--iter", type=int, default=50)
    p.add_argument("--epsICP", type=float, default=1e-5)
    p.add_argument("-a", "--algo", type=int, default=1)
    p.add_argument("--metascan", action="store_true")
    p.add_argument("-G", "--graphSlam6DAlgo", type=int, default=0)
    p.add_argument("-I", "--iterSLAM", type=int, default=50)
    p.add_argument("-D", "--distSLAM", type=float, default=25.0)
    p.add_argument("--epsSLAM", type=float, default=0.5)
    p.add_argument(
        "-C", "--clpairs", type=int, default=-1,
        help="LUM over the graph of scan pairs sharing >= N point "
        "pairs (ref slam6D -C / computeGraph6Dautomatic)",
    )
    p.add_argument("-L", "--loop6DAlgo", type=int, default=0)
    p.add_argument("--cldist", type=float, default=500.0)
    p.add_argument("--loopsize", type=int, default=20)
    p.add_argument("-n", "--net", default=None, help="explicit .net pose-graph file")
    p.add_argument(
        "--plane", dest="point_to_plane", action="store_true",
        help="point-to-plane pairing (ref CLOSEST_PLANE_SIMPLE)",
    )
    p.add_argument(
        "--normalShoot", dest="normal_shoot", action="store_true",
        help="normal-shooting pairing (ref CLOSEST_POINT_ALONG_NORMAL_SIMPLE)",
    )
    p.add_argument(
        "--cache-mb", type=int, default=0,
        help="out-of-core mode: stream scans through an LRU cache of"
        " this many MB instead of holding the sequence in RAM (the"
        " scanserver role, README.scanserver.md; sequential matching"
        " only — metascan/-L/-G need the resident driver)",
    )
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("--exportAllPoints", action="store_true")
    p.add_argument("--frames-out", default=None, help="directory for .frames (default: scan dir)")
    p.add_argument(
        "--continue", dest="continue_processing", action="store_true",
        help="resume from existing .frames (ref slam6D --continue)",
    )
    p.add_argument(
        "--prefetch", type=int, default=2,
        help="scans to read ahead in background threads (0 disables)",
    )
    p.add_argument(
        "--saveOct", dest="save_oct", action="store_true",
        help="serialize each scan's reduced points as show-compatible "
        "scanNNN.oct (ref slam6D --saveOct, Boctree.h serialize)",
    )
    p.add_argument(
        "--loadOct", dest="load_oct", action="store_true",
        help="load reduced points from existing scanNNN.oct instead of "
        "re-reducing (ref slam6D --loadOct)",
    )
    p.add_argument(
        "--mesh", choices=("none", "auto"), default="none",
        help="auto: shard ICP pair statistics and LUM links over all "
        "local devices (default none: one device)",
    )
    p.add_argument(
        "--distributed", action="store_true",
        help="multi-host execution: join the jax.distributed job "
        "(JAX_COORDINATOR/NPROC/PROC_ID env vars), host-shard scan "
        "ingest+reduction, shard the LUM link loop over the global "
        "hosts x points mesh (G/B psum across hosts)",
    )
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    dist = None
    hosts_mesh = None
    if args.distributed:
        # must run before anything touches the XLA backend
        from ..parallel import distributed as dist

        dist.initialize()
        hosts_mesh = dist.host_device_mesh(("hosts", "points"))

    from ..core.scan import TPUScan
    from ..io import frames as frames_io
    from ..io.scandir import PointFilter, read_scan_dir
    from ..models.icp import IcpParams
    from ..models.sequence import SequenceRegistration
    from ..utils.metrics import metrics, MATCHING, SCAN_LOAD

    pf = PointFilter(
        range_max=args.max_range if args.max_range > 0 else None,
        range_min=args.min_range if args.min_range > 0 else None,
        custom=args.custom_filter,
    )
    if args.cache_mb > 0:
        # out-of-core streaming mode (the scanserver role): scans page
        # through an LRU byte budget; only sequential matching
        from ..models.streaming import register_streaming

        results = register_streaming(
            args.dir, format=args.format,
            params=IcpParams(
                max_dist_match2=args.dist**2, max_iterations=args.iter,
                epsilon=args.epsICP,
            ),
            point_filter=pf,
            reduction=(args.reduce, args.octree if args.reduce > 0 else 0),
            cache_bytes=args.cache_mb << 20,
            frames_out=args.frames_out or args.dir,
            start=args.start, end=args.end,
        )
        for r in results[1:]:
            if not args.quiet:
                print(
                    f"scan {r['identifier']}: ITER {r['iterations']} "
                    f"err {r['error']:.4f}"
                )
        metrics.report()
        return 0
    if args.scans:
        # range-set DSL selection: expand against the directory and
        # narrow [start, end] (read_scan_dir filters contiguously; the
        # stepped/multi-range subset is applied after load)
        from ..io.scandir import expand_range_set, get_format, list_identifiers

        spec_fmt = get_format(args.format)
        avail = [
            int(i) for i in list_identifiers(args.dir, spec_fmt, 0, -1)
        ]
        selected = set(expand_range_set(args.scans, avail))
        if selected:
            args.start = min(selected)
            args.end = max(selected)
    else:
        selected = None
    with metrics.time(SCAN_LOAD):
        if args.distributed:
            scans = dist.distributed_ingest(
                args.dir, format=args.format, start=args.start,
                end=args.end, point_filter=pf,
                reduce_voxel=args.reduce,
                octree_n=args.octree if args.reduce > 0 else 0,
                mesh=hosts_mesh,
            )
        elif args.prefetch > 0:
            from ..io.cache import prefetch_scans

            raw_iter = prefetch_scans(
                args.dir, format=args.format, start=args.start,
                end=args.end, point_filter=pf, lookahead=args.prefetch,
            )
        else:
            raw_iter = read_scan_dir(
                args.dir, format=args.format, start=args.start,
                end=args.end, point_filter=pf,
            )
        if not args.distributed:
            scans = []
            for raw in raw_iter:
                if selected is not None and int(raw.identifier) not in selected:
                    continue
                s = TPUScan.from_raw(raw)
                s.set_reduction(
                    args.reduce, args.octree if args.reduce > 0 else 0
                )
                if args.load_oct:
                    from ..io.boctree import read_oct

                    op = os.path.join(args.dir, f"scan{s.identifier}.oct")
                    if os.path.exists(op):
                        s._reduced_local = read_oct(op)
                if args.continue_processing:
                    # resume from the last .frames pose (ref slam6D.cc:628,
                    # Scan::continueProcessing, basicScan.cc:902-945)
                    fp = frames_io.frames_path(args.dir, s.identifier)
                    if os.path.exists(fp):
                        T = frames_io.final_pose(fp)
                        s.transMat = np.asarray(T)
                        s.transMatOrg = np.asarray(T)
                        s.dalignxf = np.eye(4)
                scans.append(s)
    if not scans:
        print(f"no scans found in {args.dir}", file=sys.stderr)
        return 1
    if not args.quiet:
        print(f"loaded {len(scans)} scans from {args.dir}")

    pairing = "closest_point"
    if args.point_to_plane:
        pairing = "closest_plane"  # ref slam6D.cc:361
    if args.normal_shoot:
        pairing = "along_normal"  # ref slam6D.cc:362
    params = IcpParams(
        max_dist_match2=args.dist**2,
        max_iterations=args.iter,
        epsilon=args.epsICP,
        minimizer=ALGO_NAMES.get(args.algo, "quat"),
        subsample=max(args.random, 1),
        pairing=pairing,
    )
    out_dir = args.frames_out or args.dir
    # multi-host: matching is replicated (mesh=None — a per-ICP-
    # iteration psum across hosts would be latency-bound), the LUM link
    # loop shards over the global hosts x points mesh
    local_mesh = "auto" if args.mesh == "auto" else None
    seq_mesh = None if args.distributed else local_mesh
    lum_mesh = hosts_mesh if args.distributed else local_mesh

    def save_frames():
        """Persist pose logs; also invoked on crash/interrupt so partial
        registration survives (ref slam6D.cc:92-112 signal handler).
        Multi-host: process 0 writes (results are replicated)."""
        if args.distributed:
            import jax

            if jax.process_index() != 0:
                return
        try:
            for s in scans:
                if not s.frames:
                    continue
                mats = np.stack([f[0] for f in s.frames])
                types = [f[1] for f in s.frames]
                frames_io.write_frames(
                    frames_io.frames_path(out_dir, s.identifier), mats, types
                )
        except OSError as e:
            print(f"cannot write .frames to {out_dir}: {e}", file=sys.stderr)

    import signal

    def on_signal(signum, frame):
        print(f"signal {signum}: saving .frames before exit", file=sys.stderr)
        save_frames()
        raise SystemExit(128 + signum)

    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            signal.signal(sig, on_signal)
        except ValueError:
            pass  # not the main thread

    t0 = time.perf_counter()
    with metrics.time(MATCHING):
        if args.net:
            # explicit .net graph: sequential ICP then LUM over the
            # given links (bremen_city workflow, README.md:97-103)
            from ..models import graphslam as gs

            reg = SequenceRegistration(
                params=params, metascan=args.metascan, mesh=seq_mesh
            )
            results = reg.run(scans)
            links = gs.read_net_graph(args.net)
            gs.do_graph_slam(
                scans, links,
                gs.LumParams(
                    max_dist_match2=args.distSLAM**2 if args.distSLAM > 0 else args.dist**2,
                    iterations=args.iterSLAM,
                    epsilon=args.epsSLAM,
                    mesh=lum_mesh,
                ),
            )
        elif args.clpairs > -1:
            # ref slam6D.cc:767-779: sequential ICP, then LUM over the
            # shared-pairs graph
            from ..models import graphslam as gs

            reg = SequenceRegistration(
                params=params, metascan=args.metascan, mesh=seq_mesh
            )
            results = reg.run(scans)
            links = gs.build_clpairs_graph(
                scans, args.dist**2, args.clpairs
            )
            if len(links):
                gs.do_graph_slam(
                    scans, links,
                    gs.LumParams(
                        max_dist_match2=(
                            args.distSLAM**2 if args.distSLAM > 0
                            else args.dist**2
                        ),
                        iterations=args.iterSLAM,
                        epsilon=args.epsSLAM,
                        mesh=lum_mesh,
                    ),
                )
        elif args.graphSlam6DAlgo > 0 or args.loop6DAlgo > 0:
            from ..models.graph_pipeline import GraphPipeline

            pipe = GraphPipeline(
                icp_params=params,
                metascan=args.metascan,
                lum_max_dist2=args.distSLAM**2 if args.distSLAM > 0 else args.dist**2,
                lum_iterations=args.iterSLAM,
                lum_epsilon=args.epsSLAM,
                elch=args.loop6DAlgo in (1, 2, 3, 4),
                elch_algo=args.loop6DAlgo,
                cldist=args.cldist,
                loopsize=args.loopsize,
                slam_algo=max(args.graphSlam6DAlgo, 1),
                seq_mesh=seq_mesh,
                lum_mesh=lum_mesh,
            )
            results = pipe.run(scans)
        else:
            reg = SequenceRegistration(
                params=params, metascan=args.metascan, mesh=seq_mesh
            )
            results = reg.run(scans)
    dt = (time.perf_counter() - t0) * 1000.0
    for r in results:
        if not args.quiet:
            print(
                f"scan {r['identifier']}: ITER {r.get('iterations','-')} "
                f"err {r.get('error', float('nan')):.4f} pairs {r.get('pairs','-')}"
            )
    # ref slam6D.cc:874-875
    print(f"Matching done in {dt:.0f} milliseconds!!!")

    save_frames()

    if args.save_oct:
        from ..io.boctree import write_oct

        voxel = args.reduce if args.reduce > 0 else 10.0
        for s in scans:
            write_oct(
                os.path.join(out_dir, f"scan{s.identifier}.oct"),
                s.reduced_local(), voxel,
            )

    if args.exportAllPoints:
        from ..io.writer import write_uos

        pts = np.concatenate([s.points_global() for s in scans], axis=0)
        write_uos(os.path.join(out_dir, "points.pts"), pts)

    if not args.quiet:
        print(metrics.report())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
