"""Sequential registration driver — the JAX-native ``icp6D::doICP``
(ref src/slam6d/icp6D.cc:374-437) over a scan sequence, with odometry
extrapolation (``Scan::mergeCoordinatesWithRoboterPosition``,
scan.cc:826-833) and metascan mode (MetaScan union of previously
registered scans, include/slam6d/metaScan.h:41-71).

Host orchestration is a thin Python loop; all heavy work is the jitted
:func:`tpu3dtk.models.icp.icp_pair`.  Shapes are bucketed: every scan's
reduced points are padded to one sequence-wide cap so each (model_cap,
target_cap) pair compiles exactly once.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np

from ..core import math3d
from ..core.scan import TPUScan
from ..io.frames import AlgoType
from ..ops import nn as nn_ops
from . import icp as icp_mod

__all__ = ["SequenceRegistration", "register_sequence"]


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclasses.dataclass
class SequenceRegistration:
    """Registration run over an ordered scan list."""

    params: icp_mod.IcpParams = dataclasses.field(default_factory=icp_mod.IcpParams)
    metascan: bool = False  # ref --metascan
    max_num_metascans: int = 0  # keep only last n scans in the meta model
    extrapolate_odometry: bool = True  # ref -e / eP flag (default on)
    pad_multiple: int = 512
    # NN engine: "auto" = hashed cell list for large models, brute
    # otherwise; "brute" | "grid" force one (ref -t nns_type switch,
    # include/slam6d/scan.h:34-36).  The auto choice is PER MATCH, from
    # the actual model-window size (window_cap * point cap), never the
    # total sequence size (round-3 regression: a 100-scan sequence
    # tripped the grid for every 1-scan-window match, 50x slower).
    nns: str = "auto"
    # auto threshold on model-window points; None = the measured
    # crossover ops.nn.GRID_MIN_POINTS
    grid_min_model: int | None = None
    # fall back to brute beyond this bucket occupancy
    grid_max_cap: int = nn_ops.GRID_MAX_CAP
    # Multi-device, opt-in: "auto" shards target points over all local
    # devices (psum-merged pair stats, parallel.icp_shard) whenever more
    # than one device is present; None (default) runs single-device jit.
    # A jax.sharding.Mesh may be passed explicitly.  Sharded matching
    # runs scan by scan from the host, and on 4 H100s h468 ran slower
    # than on one card (docs/PERF.md, "Four cards").
    mesh: object = None

    def _resolve_mesh(self):
        if self.mesh == "auto":
            from ..parallel.mesh import default_points_mesh

            return default_points_mesh()
        return self.mesh or None

    def run(self, scans: list[TPUScan]) -> list[dict]:
        """Register scans sequentially.  Mutates scan poses and frames.
        Returns per-match info dicts.

        Fast path: when no caller needs per-match poses (that is, the
        whole sequence is registered in one go — unlike GraphPipeline,
        whose loop detection must observe every new pose), the ENTIRE
        loop runs on device in one jitted fori_loop
        (icp.register_sequence_device): zero host round trips per match,
        one fetch at the end.  Falls back to per-match run_single under
        a mesh or when the hashed-grid engine is selected."""
        if not scans:
            return []
        prep = self._prepare(scans)
        win_max = (
            (self.max_num_metascans or len(scans)) if self.metascan else 1
        )
        use_device_loop = (
            prep["mesh"] is None
            and not (
                prep["grid_buckets"]
                and (
                    self.nns == "grid"
                    or win_max * prep["cap"] >= prep["grid_min"]
                )
            )
        )
        if use_device_loop:
            return self._run_device(scans, prep, win_max)
        return [self.run_single(scans, i) for i in range(1, len(scans))]

    def _run_device(self, scans: list[TPUScan], prep: dict, win_max: int):
        import jax.numpy as jnp

        from ..utils.metrics import MATCHING, metrics

        S = len(scans)
        mats_org = np.stack([s.transMatOrg for s in scans]).astype(np.float32)
        mats0 = np.stack([s.transMat for s in scans]).astype(np.float32)
        with metrics.time(MATCHING):
            mats, errs, iters, npairs = icp_mod.register_sequence_device(
                prep["locals"], prep["masks"], prep["normals"],
                jnp.asarray(mats_org), jnp.asarray(mats0), jnp.int32(S),
                self.params.max_dist_match2, self.params.epsilon,
                metascan=self.metascan,
                extrapolate=self.extrapolate_odometry,
                window_cap=win_max,
                max_iterations=self.params.max_iterations,
                minimizer=self.params.minimizer,
                subsample=self.params.subsample,
                pairing=self.params.pairing,
                has_normals=prep["has_normals"],
            )
            mats, errs, iters, npairs = jax.device_get(
                (mats, errs, iters, npairs)
            )
        # replay frames bookkeeping: one match event per scan i (the
        # loop body of doICP — same records run_single writes)
        infos = []
        for i in range(1, S):
            cur = scans[i]
            T_new = np.asarray(mats[i], np.float64)
            u, _, vt = np.linalg.svd(T_new[:3, :3])
            T_new[:3, :3] = u @ vt
            cur.set_pose(T_new, AlgoType.ICP)
            for j, other in enumerate(scans):
                if other is cur:
                    continue
                other.add_frame(
                    AlgoType.ICPINACTIVE if j < i else AlgoType.INVALID
                )
            infos.append({
                "identifier": cur.identifier,
                "iterations": int(iters[i]),
                "error": float(errs[i]),
                "pairs": int(npairs[i]),
            })
        return infos

    def _prepare(self, scans: list[TPUScan]) -> dict:
        """Upload the sequence ONCE as resident [S, N, 3] device tensors
        and size the hash spec once — per-match work shrinks to a tiny
        pose-matrix upload + one jitted call (the reference instead
        keeps a kd-tree resident per scan, basicScan.cc:702-728; the
        round-2 driver rebuilt + re-uploaded the metascan model on the
        host every match, 15 ms/iter of overhead)."""
        key = (
            tuple(
                (s.identifier, s.generation, len(s.reduced_local()))
                for s in scans
            ),
            self.params,
        )
        prep = getattr(self, "_prep", None)
        if prep is not None and prep["key"] == key:
            return prep
        import jax.numpy as jnp

        mesh = self._resolve_mesh()
        pad_to = self.pad_multiple
        if mesh is not None:
            pad_to = _round_up(pad_to, mesh.devices.size)
        cap = _round_up(max(len(s.reduced_local()) for s in scans), pad_to)
        S = len(scans)
        locals_pad = np.zeros((S, cap, 3), np.float32)
        masks = np.zeros((S, cap), bool)
        for si, s in enumerate(scans):
            r = s.reduced_local()
            locals_pad[si, : len(r)] = r
            masks[si, : len(r)] = True
        need_normals = (
            self.params.pairing != "closest_point"
            or self.params.minimizer == "napx"
        )
        if need_normals:
            normals_pad = np.stack(
                [s.reduced_normals_padded(cap) for s in scans]
            ).astype(np.float32)
        else:
            normals_pad = np.zeros((1, 1, 3), np.float32)  # unused dummy

        grid_min = self.grid_min_model
        if grid_min is None:
            grid_min = nn_ops.GRID_MIN_POINTS
        # largest model window any match of this run can see
        if self.metascan:
            win_max = self.max_num_metascans or S
        else:
            win_max = 1
        grid_buckets = grid_cap = 0
        use_grid = self.nns == "grid" or (
            self.nns == "auto" and win_max * cap >= grid_min
        )
        if use_grid and self.params.pairing != "along_normal":
            max_dist = float(np.sqrt(self.params.max_dist_match2))
            if win_max == 1:
                # the model is one scan: size from each scan alone
                # (stacking overlapping scans overstates the occupancy)
                from .graphslam import local_grid_spec

                grid_buckets, grid_cap = local_grid_spec(
                    scans, max_dist, self.grid_max_cap
                )
            else:
                # occupancy of the FULL stacked metascan at current poses
                # (density is pose-invariant up to overlap drift; the
                # per-match maxocc guard keeps exactness)
                all_g = np.concatenate([
                    np.asarray(
                        math3d.transform3(s.transMat, s.reduced_local())
                    )
                    for s in scans
                ]).astype(np.float32)
                H, bc = nn_ops.cell_hash_spec(
                    all_g, np.ones(len(all_g), bool), max_dist
                )
                bcap = ((int(bc * 1.5) + 7) // 8) * 8
                if bcap <= self.grid_max_cap:
                    grid_buckets, grid_cap = H, bcap

        prep = dict(
            key=key,
            mesh=mesh,
            cap=cap,
            locals=jnp.asarray(locals_pad),
            masks=jnp.asarray(masks),
            normals=jnp.asarray(normals_pad),
            has_normals=need_normals,
            grid_buckets=grid_buckets,
            grid_cap=grid_cap,
            grid_min=grid_min,
        )
        self._prep = prep
        return prep

    def run_single(self, scans: list[TPUScan], i: int) -> dict:
        """Register scan i against the previous scan (or metascan of all
        earlier scans): odometry extrapolation + one jitted ICP match +
        frames bookkeeping (the loop body of doICP, icp6D.cc:383-437).

        Frame bookkeeping mirrors reference transform(islum=0): every
        match event appends a frame to every scan (ICP for current,
        ICPINACTIVE for already-registered, INVALID for future scans).
        """
        prep = self._prepare(scans)
        mesh = prep["mesh"]
        cur = scans[i]
        prev = scans[i - 1]
        if self.extrapolate_odometry:
            # deltaMat = prev.transMat @ inv(prev.transMatOrg)
            delta = prev.transMat @ np.asarray(
                math3d.m4inv(prev.transMatOrg)
            )
            cur.transform(delta, AlgoType.INVALID, record=False)

        if self.metascan:
            lo = 0
            window_cap = len(scans)
            if self.max_num_metascans > 0:
                lo = max(0, i - self.max_num_metascans)
                window_cap = self.max_num_metascans
        else:
            lo = i - 1
            window_cap = 1

        statics = dict(
            max_iterations=self.params.max_iterations,
            minimizer=self.params.minimizer,
            subsample=self.params.subsample,
            pairing=self.params.pairing,
            has_normals=prep["has_normals"],
        )
        T0 = cur.transMat.astype(np.float32)
        mats = np.stack([s.transMat for s in scans]).astype(np.float32)
        from ..utils.metrics import MATCHING, metrics

        def match(grid_buckets, grid_cap):
            args = (
                prep["locals"], prep["masks"], prep["normals"], mats,
                lo, i, i, T0,
                self.params.max_dist_match2, self.params.epsilon, i,
            )
            kw = dict(statics, grid_buckets=grid_buckets,
                      grid_bucket_cap=grid_cap)
            if mesh is not None:
                from ..parallel import icp_shard

                return icp_shard.icp_pair_seq_sharded(
                    mesh, *args, **kw, window_cap=window_cap
                )
            return icp_mod.icp_pair_seq(*args, **kw, window_cap=window_cap)

        # per-match engine choice from the ACTUAL model-window size
        # (window_cap scans x cap points) — never the whole-sequence
        # total (round-3 regression: the grid fired for 1-scan windows)
        gb, gc = prep["grid_buckets"], prep["grid_cap"]
        if self.nns == "auto" and window_cap * prep["cap"] < prep["grid_min"]:
            gb = gc = 0
        with metrics.time(MATCHING):
            res = match(gb, gc)
            if gb and int(res.maxocc) > gc:
                # hash overflow: exactness guard — redo with brute NN
                res = match(0, 0)
            # one packed device->host transfer instead of one per leaf
            res = icp_mod.unpack_result(
                np.asarray(icp_mod.pack_result(res))
            )
        T_new = np.asarray(res.T, dtype=np.float64)
        # orthonormalize the accumulated f32 rotation before storing
        R = T_new[:3, :3]
        u, _, vt = np.linalg.svd(R)
        T_new[:3, :3] = u @ vt
        cur.set_pose(T_new, AlgoType.ICP)
        for j, other in enumerate(scans):
            if other is cur:
                continue
            other.add_frame(
                AlgoType.ICPINACTIVE if j < i else AlgoType.INVALID
            )
        return {
            "identifier": cur.identifier,
            "iterations": int(res.iterations),
            "error": float(res.error),
            "pairs": int(res.n_pairs),
        }


def register_sequence(scans: list[TPUScan], **kwargs) -> list[dict]:
    params_keys = icp_mod.IcpParams._fields
    params = icp_mod.IcpParams(
        **{k: v for k, v in kwargs.items() if k in params_keys}
    )
    driver_kwargs = {k: v for k, v in kwargs.items() if k not in params_keys}
    return SequenceRegistration(params=params, **driver_kwargs).run(scans)
