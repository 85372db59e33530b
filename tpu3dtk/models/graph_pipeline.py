"""Full SLAM pipeline: sequential ICP + loop detection + ELCH loop
closure + LUM GraphSLAM relaxation — the JAX-native
``matchGraph6Dautomatic`` (ref src/slam6d/slam6D.cc:387-548).

Per scan i: odometry extrapolation, ICP against previous scan (or
metascan), loop detection by pose proximity (dist < cldist, j < i -
loopsize); one scan after a loop is detected, run ELCH on the closest
(first, last) pair and then LUM over the proximity graph until
convergence.  Final passes re-run LUM with -D (mdml) and optionally
--DlastSLAM/--graphDist (mdmll) distances.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core import math3d
from ..core.scan import TPUScan
from ..ops import nn as nn_ops
from . import elch as elch_mod
from . import graphslam as gs
from .icp import IcpParams
from .sequence import SequenceRegistration

__all__ = ["GraphPipeline"]


@dataclasses.dataclass
class GraphPipeline:
    icp_params: IcpParams = dataclasses.field(default_factory=IcpParams)
    metascan: bool = False
    lum_max_dist2: float = 625.0  # -D
    lum_iterations: int = 50  # -I
    lum_epsilon: float = 0.5  # --epsSLAM
    elch: bool = False  # loop closing enabled (-L > 0)
    elch_algo: int = 4  # -L: 1 euler, 2 quat, 3 unitQuat, 4 slerp
    cldist: float = 500.0
    loopsize: int = 20
    mdmll: float = -1.0  # --DlastSLAM (final pass match distance)
    graph_dist: float = -1.0  # --graphDist (final pass graph distance)
    slam_algo: int = 1  # -G: 1 lum6DEuler, 2 lum6DQuat, 3 ghelix6DQ2, 4 gapx6D
    # LUM iterations for the PER-CLOSURE relax (the reference runs
    # doGraphSlam6D(gr, allScans, 1) inside the loop, slam6D.cc:508,
    # and the full -I budget only in the final passes).  None = use
    # lum_iterations for both (the behavior of earlier rounds).
    closure_lum_iterations: int | None = None
    # meshes (SequenceRegistration.mesh, LumParams.mesh): None = one
    # device, "auto" = shard over all local devices (opt-in); the
    # distributed CLI pins lum_mesh=the global hosts x points mesh (link
    # loop sharded, G/B psum across hosts)
    seq_mesh: object = None
    lum_mesh: object = None
    # device-resident sequential phase: matching + loop detection in
    # on-device segments, one fetch per closure (falls back to the
    # host loop under a mesh or a non-brute NN engine)
    device_segments: bool = True

    def _do_graph_slam(self, scans, links, params):
        if self.slam_algo in (0, 1):
            return gs.do_graph_slam(scans, links, params)
        from .graphslam_variants import GRAPHSLAM_VARIANTS

        return GRAPHSLAM_VARIANTS[self.slam_algo](scans, links, params)

    def _lum_params(
        self, max_dist2: float, iterations: int | None = None
    ) -> "gs.LumParams":
        """LumParams with the sequence-wide pinned shapes: ONE point
        cap, ONE scan cap, ONE hash spec and the pre-uploaded device
        tensors, so every LUM invocation over a growing prefix reuses
        one compiled executable."""
        p = gs.LumParams(
            max_dist_match2=max_dist2,
            iterations=(
                self.lum_iterations if iterations is None else iterations
            ),
            epsilon=self.lum_epsilon,
            scan_cap=self._scan_cap,
            device_points=self._device_points,
            grid=self._grid_specs.get(max_dist2),
            mesh=self.lum_mesh,
            corr_cache=self._lum_corr_cache,
        )
        return p

    def _prepare_statics(self, scans) -> None:
        import jax.numpy as jnp

        cap = max(len(s.reduced_local()) for s in scans)
        pm = 512
        cap = ((cap + pm - 1) // pm) * pm
        locals_pad, masks = gs._pad_scan_points(scans, cap)
        self._scan_cap = len(scans)
        self._device_points = (jnp.asarray(locals_pad), jnp.asarray(masks))
        # correspondence caches for the continuous-closure regime: one
        # for the per-closure 1-iteration LUM link set, one for the ELCH
        # edge covariances (different link sets — separate slot spaces)
        from .lum_device import CorrCache

        self._lum_corr_cache = CorrCache(cap)
        self._elch_corr_cache = CorrCache(cap)
        self._grid_specs = {}
        dists = {self.lum_max_dist2}
        if self.mdmll > 0:
            dists.add(self.mdmll**2)
        for d2 in dists:
            if d2 > 0 and cap >= nn_ops.GRID_MIN_POINTS:
                self._grid_specs[d2] = gs.local_grid_spec(
                    scans, float(np.sqrt(d2)), nn_ops.GRID_MAX_CAP
                )

    def run(self, scans: list[TPUScan]) -> list[dict]:
        n = len(scans)
        cld2 = self.cldist**2
        results: list[dict] = []
        edges: list[tuple[int, int]] = []
        self._prepare_statics(scans)
        seq = SequenceRegistration(
            params=self.icp_params, metascan=self.metascan,
            mesh=self.seq_mesh,
        )
        if self.device_segments and n > 1:
            prep = seq._prepare(scans)
            win_max = (len(scans) if self.metascan else 1)
            eligible = (
                prep["mesh"] is None
                and not (
                    prep["grid_buckets"]
                    and (
                        seq.nns == "grid"
                        or win_max * prep["cap"] >= prep["grid_min"]
                    )
                )
            )
            if eligible:
                return self._run_segmented(scans, seq, prep, win_max)
        loop_state = 0
        min_dist = -1.0
        first = last = 0

        for i in range(1, n):
            edges.append((i - 1, i))
            # ICP step vs previous (reuse driver on the 2-scan window;
            # it extrapolates odometry and records frames globally)
            r = seq.run_single(scans, i)
            results.append(r)

            if loop_state == 1:
                loop_state = 2
            for j in range(0, i - self.loopsize):
                d = float(
                    np.sum((scans[j].rPos - scans[i].rPos) ** 2)
                )
                if d < cld2:
                    loop_state = max(loop_state, 1)
                    if min_dist < 0 or d < min_dist:
                        min_dist = d
                        first, last = j, i

            if loop_state == 2:
                loop_state = 0
                min_dist = -1.0
                self._close_and_relax(scans, first, last, edges, upto=i)

        if loop_state == 1 and self.elch:
            self._close_and_relax(scans, first, last, edges, upto=n - 1)

        # final LUM passes (slam6D.cc:520-547)
        if self.lum_iterations > 0 and self.lum_max_dist2 > 0:
            self._relax(scans, self.lum_max_dist2, cld2)
        if self.mdmll > 0:
            gd2 = self.graph_dist**2 if self.graph_dist > 0 else cld2
            self._relax(scans, self.mdmll**2, gd2)
        return results

    def _run_segmented(self, scans: list[TPUScan], seq, prep, win_max):
        """Device-resident sequential phase: matching AND loop detection
        run in on-device segments (icp.register_segment_device) — ONE
        packed fetch per loop closure instead of one per match; ELCH +
        LUM run host-orchestrated between segments on the fetched poses
        (the ref interleaving of matchGraph6Dautomatic, slam6D.cc:387-548).

        Produces the same poses, frames records and per-match infos as
        the host-loop path (asserted by tests/test_graph_pipeline_device)."""
        import jax.numpy as jnp

        from ..io.frames import AlgoType
        from ..utils.metrics import MATCHING, metrics
        from .icp import register_segment_device, unpack_segment

        n = len(scans)
        cld2 = float(self.cldist**2)
        results: list[dict] = []
        edges: list[tuple[int, int]] = []
        mats_org = np.stack([s.transMatOrg for s in scans]).astype(np.float32)
        state = (0, -1.0, 0, 0)  # loop_state, min_dist, first, last
        i_start = 1
        while i_start < n:
            mats0 = np.stack([s.transMat for s in scans]).astype(np.float32)
            with metrics.time(MATCHING):
                packed = register_segment_device(
                    prep["locals"], prep["masks"], prep["normals"],
                    jnp.asarray(mats_org), jnp.asarray(mats0),
                    jnp.int32(i_start), jnp.int32(n),
                    jnp.int32(self.loopsize), jnp.float32(cld2),
                    jnp.asarray(np.asarray(state, np.float32)),
                    self.icp_params.max_dist_match2, self.icp_params.epsilon,
                    metascan=self.metascan,
                    extrapolate=seq.extrapolate_odometry,
                    window_cap=win_max,
                    max_iterations=self.icp_params.max_iterations,
                    minimizer=self.icp_params.minimizer,
                    subsample=self.icp_params.subsample,
                    pairing=self.icp_params.pairing,
                    has_normals=prep["has_normals"],
                )
                seg = unpack_segment(packed, n)  # the one fetch
            # replay pose + frames bookkeeping for the matched span
            for i in range(i_start, seg["i_next"]):
                cur = scans[i]
                T_new = np.asarray(seg["mats"][i], np.float64)
                u, _, vt = np.linalg.svd(T_new[:3, :3])
                T_new[:3, :3] = u @ vt
                cur.set_pose(T_new, AlgoType.ICP)
                for j, other in enumerate(scans):
                    if other is cur:
                        continue
                    other.add_frame(
                        AlgoType.ICPINACTIVE if j < i else AlgoType.INVALID
                    )
                edges.append((i - 1, i))
                results.append({
                    "identifier": cur.identifier,
                    "iterations": int(seg["iters"][i]),
                    "error": float(seg["errs"][i]),
                    "pairs": int(seg["npairs"][i]),
                })
            upto = seg["i_next"] - 1
            if seg["loop_state"] >= 2:
                self._close_and_relax(
                    scans, seg["first"], seg["last"], edges, upto=upto
                )
                state = (0, -1.0, 0, 0)
            else:
                state = (
                    seg["loop_state"], seg["min_dist"],
                    seg["first"], seg["last"],
                )
            i_start = seg["i_next"]

        if state[0] == 1 and self.elch:
            self._close_and_relax(
                scans, state[2], state[3], edges, upto=n - 1
            )
        if self.lum_iterations > 0 and self.lum_max_dist2 > 0:
            self._relax(scans, self.lum_max_dist2, cld2)
        if self.mdmll > 0:
            gd2 = self.graph_dist**2 if self.graph_dist > 0 else cld2
            self._relax(scans, self.mdmll**2, gd2)
        return results

    def _close_and_relax(self, scans, first, last, edges, upto):
        from ..utils.metrics import metrics

        if self.elch:
            close_fn = elch_mod.ELCH_VARIANTS.get(
                self.elch_algo, elch_mod.close_loop
            )
            with metrics.time("elch_time"):
                close_fn(
                    scans[: upto + 1],
                    first,
                    last,
                    [e for e in edges if e[1] <= upto],
                    elch_mod.ElchParams(
                        max_dist_match2=self.icp_params.max_dist_match2,
                        icp_iterations=self.icp_params.max_iterations,
                        # converge the loop ICP with the same epsilon
                        # as the sequential matches (the 1e-7 default
                        # forces max_iterations at large scan sizes)
                        icp_epsilon=self.icp_params.epsilon,
                        scan_cap=self._scan_cap,
                        device_points=self._device_points,
                        corr_cache=self._elch_corr_cache,
                    ),
                )
            edges.append((first, last))
        if self.lum_iterations > 0 and self.lum_max_dist2 > 0:
            sub = scans[: upto + 1]
            positions = np.stack([s.rPos for s in sub])
            links = gs.build_proximity_graph(
                positions, self.cldist**2, self.loopsize
            )
            self._do_graph_slam(
                sub, links,
                self._lum_params(
                    self.lum_max_dist2,
                    iterations=self.closure_lum_iterations,
                ),
            )

    def _relax(self, scans, max_dist2, graph_cld2):
        positions = np.stack([s.rPos for s in scans])
        links = gs.build_proximity_graph(positions, graph_cld2, self.loopsize)
        self._do_graph_slam(scans, links, self._lum_params(max_dist2))
