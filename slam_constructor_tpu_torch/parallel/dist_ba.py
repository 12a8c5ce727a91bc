"""The pose-graph solve over ranks (port of
``slam_constructor_tpu.parallel.dist_ba``).

Each rank owns a contiguous shard of the edge table, assembles its partial
normal equations ``H_p = A_p^T W A_p``, ``b_p = A_p^T W e_p`` over its
edges (``models.posegraph.optimize_checked``'s math, the Huber kernel on
loop edges included), and one all-reduce adds them. The small dense system
is then solved alike on every rank: by Cholesky (``cholesky_ex``, the
unsharded solve's) or, with ``schur_split``, by eliminating the trailing
keyframes first (``posegraph.schur_solve``). It runs at loop-closure rate,
so the all-reduce may cross hosts (the ``"hosts"`` axis).
"""

from __future__ import annotations

import dataclasses

import torch

from ..models import posegraph as pg
from ..ops import libm
from ..ops.geometry import wrap_angle
from . import mesh as meshlib

Tensor = torch.Tensor


def _partial_normal_equations(poses: Tensor, ei: Tensor, ej: Tensor, ez: Tensor, einfo: Tensor,
                              emask: Tensor, eloop: Tensor, kmax: int, huber_delta: float):
    """(H f32[3K, 3K], b f32[3K]) of a shard of edges: each edge's two 3x3
    Jacobian blocks placed by one-hot factors and multiplied out, as the
    unsharded solve does."""
    n_e = ei.shape[0]
    e, ji, jj = pg._edge_residual_jac(poses[ei], poses[ej], ez)
    w = einfo * emask[:, None]
    if huber_delta > 0:
        chi = libm.sqrt(torch.clamp((w * e * e).sum(-1), min=1e-12), inplace=True)
        delta = torch.full_like(chi, huber_delta)
        w = w * torch.where(eloop, torch.clamp(delta / chi, max=1.0), 1.0)[:, None]
    oh_i = torch.nn.functional.one_hot(ei, kmax).to(torch.float32)
    oh_j = torch.nn.functional.one_hot(ej, kmax).to(torch.float32)
    a = (oh_i[:, None, :, None] * ji[:, :, None, :]
         + oh_j[:, None, :, None] * jj[:, :, None, :]).reshape(3 * n_e, 3 * kmax)
    wa = w.reshape(-1, 1) * a
    return a.T @ wa, wa.T @ e.reshape(-1)


def distributed_optimize(cfg: pg.PoseGraphConfig, st: pg.PoseGraphState, mesh,
                         axis: str = "hosts", schur_split: int | None = None
                         ) -> pg.PoseGraphState:
    """Gauss-Newton with the normal equations assembled over this rank's
    edges and added over ``axis``; ``st`` is the whole graph on every rank
    (the edge capacity must divide the ranks). ``schur_split`` (in
    keyframes) solves by Schur elimination. Equal to
    ``posegraph.optimize`` up to the order of the float sums."""
    kmax = cfg.max_keyframes
    dev = st.device
    lo, hi = meshlib.shard_bounds(st.edge_i.shape[0], mesh, axis)
    e_mask = (torch.arange(lo, hi, device=dev) < st.n_edges).to(torch.float32)
    ei, ej = st.edge_i[lo:hi].long(), st.edge_j[lo:hi].long()
    k_idx = torch.arange(kmax, device=dev)
    dof_used = ((k_idx < st.n_kf) & (k_idx > 0)).repeat_interleave(3)
    diag = torch.diag(torch.where(dof_used, cfg.gn_damping, 1.0))

    poses = st.kf_poses
    for _ in range(cfg.gn_iterations):
        h_p, b_p = _partial_normal_equations(
            poses, ei, ej, st.edge_delta[lo:hi], st.edge_info[lo:hi], e_mask,
            st.edge_is_loop[lo:hi], kmax, cfg.huber_delta)
        h = meshlib.psum(h_p, mesh, axis)
        b = meshlib.psum(b_p, mesh, axis)
        h = torch.where(dof_used[:, None] & dof_used[None, :], h, 0.0) + diag
        b = torch.where(dof_used, b, 0.0)
        if schur_split is not None:
            dx = pg.schur_solve(h, -b, 3 * schur_split)
        else:
            chol, _ = torch.linalg.cholesky_ex(h)
            dx = torch.cholesky_solve(-b[:, None], chol)[:, 0]
        new = poses + dx.reshape(kmax, 3)
        poses = torch.cat([new[:, :2], wrap_angle(new[:, 2:])], dim=-1)
    return dataclasses.replace(st, kf_poses=poses)
