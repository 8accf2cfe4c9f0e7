"""Box alignment (CoAlign): agent-pose refinement from shared detections.

The port's copy of heal_tpu/utils/box_align.py. Agents exchange their
single-view detected box centers (and uncertainties); the centers are
clustered into landmarks across agents, and each non-ego agent's SE(2)
pose is moved so its boxes land on the shared landmarks, correcting
localization noise before the feature warps. A small dense Gauss-Newton
on (x, y, yaw) per agent with the ego fixed, float64 numpy on the host.
"""
from __future__ import annotations

import numpy as np

from .common_np import limit_period


def uncertainty_to_weights(u) -> np.ndarray:
    """Per-box aleatoric uncertainty -> landmark weight for box-align.

    u: (K, >=2) decode export, log-variance x / y (+ log-kappa yaw); the
    weight is the inverse variance exp(-mean(log var)). Shared by the
    data hook (data/builder.py) and tools/pose_graph_evaluate.py.
    """
    u = np.asarray(u, np.float64)
    if u.size == 0:
        return np.ones(0)
    return np.exp(-u[:, :2].mean(axis=1))


def _se2_apply(pose, pts):
    """pose (3,) [x, y, yaw]; pts (N, 2) -> world (N, 2)."""
    c, s = np.cos(pose[2]), np.sin(pose[2])
    rot = np.array([[c, -s], [s, c]])
    return pts @ rot.T + pose[:2]


def cluster_boxes(world_centers: list, landmark_thresh: float = 2.0):
    """Greedy cross-agent clustering of box centers, at most one box per
    agent in a cluster.

    world_centers: list over agents of (K_i, 2). Returns the clusters,
    each a list of (agent_idx, box_idx).
    """
    clusters: list = []
    centers: list = []
    for ai, boxes in enumerate(world_centers):
        for bi, c in enumerate(boxes):
            best, best_d = -1, landmark_thresh
            for ci, cc in enumerate(centers):
                d = np.linalg.norm(cc - c)
                if d < best_d:
                    if any(a == ai for a, _ in clusters[ci]):
                        continue
                    best, best_d = ci, d
            if best < 0:
                clusters.append([(ai, bi)])
                centers.append(np.asarray(c, dtype=np.float64))
            else:
                clusters[best].append((ai, bi))
                members = clusters[best]
                centers[best] = np.mean(
                    [world_centers[a][b] for a, b in members], axis=0
                )
    return clusters


def box_alignment_relative(
    pred_centers: list,
    noisy_poses: np.ndarray,
    uncertainties: list | None = None,
    landmark_thresh: float = 2.0,
    iterations: int = 10,
):
    """Refine agent poses from shared box detections.

    pred_centers: list over agents of (K_i, 2) box centers in each
    agent's own frame; noisy_poses: (L, 6) 6-dof poses (degrees) with
    localization noise; uncertainties: optional per-agent (K_i,) weights
    (inverse variance).

    Returns (L, 6) refined poses (x, y, yaw updated; z, roll, pitch
    kept). Agent 0 (the ego) stays fixed: the refinement is relative.
    """
    n_agents = len(pred_centers)
    poses = np.asarray(noisy_poses, dtype=np.float64).copy()
    se2 = np.stack(
        [poses[:, 0], poses[:, 1], np.radians(poses[:, 4])], axis=1
    )
    weights = [
        np.ones(len(c)) if uncertainties is None
        else np.asarray(uncertainties[i])
        for i, c in enumerate(pred_centers)
    ]

    for _ in range(iterations):
        world = [
            _se2_apply(se2[i], np.asarray(pred_centers[i]).reshape(-1, 2))
            for i in range(n_agents)
        ]
        clusters = cluster_boxes(world, landmark_thresh)
        # landmarks from the clusters seen by >= 2 agents
        landmarks = []
        obs = []  # (agent, box, landmark)
        for cl in clusters:
            if len(cl) < 2:
                continue
            lid = len(landmarks)
            # ego-anchored landmarks: the ego frame is the gauge reference,
            # so a cluster holding an ego detection uses it directly
            ego_boxes = [world[a][b] for a, b in cl if a == 0]
            if ego_boxes:
                landmarks.append(np.mean(ego_boxes, axis=0))
            else:
                landmarks.append(
                    np.mean([world[a][b] for a, b in cl], axis=0)
                )
            obs += [(a, b, lid) for a, b in cl]
        if not landmarks:
            break

        # one Gauss-Newton step per agent, landmarks held fixed
        converged = True
        for ai in range(1, n_agents):
            rows = [(b, k) for a, b, k in obs if a == ai]
            if not rows:
                continue
            jtj = np.zeros((3, 3))
            jtr = np.zeros(3)
            c, s = np.cos(se2[ai, 2]), np.sin(se2[ai, 2])
            for b, k in rows:
                p = np.asarray(pred_centers[ai][b], dtype=np.float64)
                w = weights[ai][b]
                pred = _se2_apply(se2[ai], p[None])[0]
                r = pred - landmarks[k]
                # d(pred) / d(x, y, yaw)
                jac = np.array(
                    [
                        [1.0, 0.0, -s * p[0] - c * p[1]],
                        [0.0, 1.0, c * p[0] - s * p[1]],
                    ]
                )
                jtj += w * jac.T @ jac
                jtr += w * jac.T @ r
            jtj += 1e-6 * np.eye(3)
            delta = np.linalg.solve(jtj, -jtr)
            se2[ai] += delta
            if np.linalg.norm(delta) > 1e-6:
                converged = False
        if converged:
            break

    refined = poses.copy()
    refined[:, 0] = se2[:, 0]
    refined[:, 1] = se2[:, 1]
    refined[:, 4] = np.degrees(limit_period(se2[:, 2]))
    return refined
