"""Pose-graph refinement over all confident pair edges, host numpy (the
port's copy of mapmerge_tpu/graph/pose_graph.py, with the options the port
never sets fixed at the reference's defaults).

The reference chains transforms over the maximum spanning tree only
(map_merge_3d/src/map_merging.cpp:137-186), so per-hop error compounds.
estimate_maps_transforms registers every pair anyway, so after the tree
seed a damped Gauss-Newton on SE(3) relaxes the whole confident edge set.

Conventions (those of graph/merge_graph.py):
  - global[i] maps map-i coordinates into the reference frame;
  - an edge (source i, target j, T) constrains global[i] = global[j] @ T;
  - se(3) vectors are (rho, phi): translation first, rotation second;
  - right perturbation G <- G @ exp(delta).

Residual per edge: r = log((G_j T)^-1 G_i), weighted by confidence under a
Huber kernel whose knee follows the residuals; the tree's reference node is
held fixed (gauge). MergeParams.strict_parity() switches it off.
"""

from __future__ import annotations

import numpy as np

_EPS = 1e-9
_MAX_ITERATIONS = 50
_TOL = 1e-10
#: an edge farther than this from the tree seed is a wrong registration
_SEED_GATE_DEG = 25.0
_SEED_GATE_M = 1.5
#: rounds of gross-edge rejection
_REJECT_DEPTH = 3


def _hat(w: np.ndarray) -> np.ndarray:
    """(..., 3) -> (..., 3, 3) skew-symmetric."""
    out = np.zeros(w.shape[:-1] + (3, 3), w.dtype)
    out[..., 0, 1] = -w[..., 2]
    out[..., 0, 2] = w[..., 1]
    out[..., 1, 0] = w[..., 2]
    out[..., 1, 2] = -w[..., 0]
    out[..., 2, 0] = -w[..., 1]
    out[..., 2, 1] = w[..., 0]
    return out


def so3_log(R: np.ndarray) -> np.ndarray:
    """(..., 3, 3) -> (..., 3) rotation vector (batched, stable to pi)."""
    tr = np.trace(R, axis1=-2, axis2=-1)
    cos = np.clip((tr - 1.0) * 0.5, -1.0, 1.0)
    theta = np.arccos(cos)
    vee = np.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )
    sin = np.sin(theta)
    small = theta < 1e-5
    # theta / (2 sin theta), Taylor 1/2 + theta^2/12 near zero
    factor = np.where(
        small, 0.5 + theta**2 / 12.0, theta / np.maximum(2.0 * sin, _EPS)
    )
    w = factor[..., None] * vee
    # near pi the vee part vanishes: the axis comes from the diagonal
    near_pi = theta > np.pi - 1e-3
    if np.any(near_pi):
        diag = np.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], axis=-1)
        axis_sq = np.maximum((diag + 1.0) * 0.5, 0.0)
        axis = np.sqrt(axis_sq)
        # signs from the off-diagonals, relative to the largest axis
        k = np.argmax(axis_sq, axis=-1)
        flat_axis = axis.reshape(-1, 3)
        flat_R = R.reshape(-1, 3, 3)
        for n, kk in enumerate(np.ravel(k)):
            a, b = (kk + 1) % 3, (kk + 2) % 3
            if flat_R[n, kk, a] + flat_R[n, a, kk] < 0:
                flat_axis[n, a] = -flat_axis[n, a]
            if flat_R[n, kk, b] + flat_R[n, b, kk] < 0:
                flat_axis[n, b] = -flat_axis[n, b]
        w = np.where(near_pi[..., None], theta[..., None] * axis, w)
    return w


def so3_exp(w: np.ndarray) -> np.ndarray:
    """(..., 3) -> (..., 3, 3) Rodrigues."""
    theta = np.linalg.norm(w, axis=-1)
    small = theta < 1e-7
    th = np.where(small, 1.0, theta)
    a = np.where(small, 1.0 - theta**2 / 6.0, np.sin(th) / th)
    b = np.where(small, 0.5 - theta**2 / 24.0, (1.0 - np.cos(th)) / th**2)
    W = _hat(w)
    eye = np.broadcast_to(np.eye(3), W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * (W @ W)


def _so3_left_jacobian(w: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(w, axis=-1)
    small = theta < 1e-7
    th = np.where(small, 1.0, theta)
    b = np.where(small, 0.5 - theta**2 / 24.0, (1.0 - np.cos(th)) / th**2)
    c = np.where(small, 1.0 / 6.0 - theta**2 / 120.0, (th - np.sin(th)) / th**3)
    W = _hat(w)
    eye = np.broadcast_to(np.eye(3), W.shape)
    return eye + b[..., None, None] * W + c[..., None, None] * (W @ W)


def se3_exp(xi: np.ndarray) -> np.ndarray:
    """(..., 6) (rho, phi) -> (..., 4, 4)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    V = _so3_left_jacobian(phi)
    T = np.zeros(xi.shape[:-1] + (4, 4), np.float64)
    T[..., :3, :3] = R
    T[..., :3, 3] = np.einsum("...ij,...j->...i", V, rho)
    T[..., 3, 3] = 1.0
    return T


def se3_log(T: np.ndarray) -> np.ndarray:
    """(..., 4, 4) -> (..., 6) (rho, phi)."""
    phi = so3_log(T[..., :3, :3])
    V = _so3_left_jacobian(phi)
    rho = np.linalg.solve(V, T[..., :3, 3, None])[..., 0]
    return np.concatenate([rho, phi], axis=-1)


def _se3_adjoint(T: np.ndarray) -> np.ndarray:
    """Adjoint of SE(3) matrices in (rho, phi) order: (..., 6, 6)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    out = np.zeros(T.shape[:-2] + (6, 6), np.float64)
    out[..., :3, :3] = R
    out[..., :3, 3:] = _hat(t) @ R
    out[..., 3:, 3:] = R
    return out


def _se3_ad(xi: np.ndarray) -> np.ndarray:
    """Little adjoint ad(xi) in (rho, phi) order: (..., 6, 6)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    out = np.zeros(xi.shape[:-1] + (6, 6), np.float64)
    P = _hat(phi)
    out[..., :3, :3] = P
    out[..., :3, 3:] = _hat(rho)
    out[..., 3:, 3:] = P
    return out


def _jr_inv(r: np.ndarray) -> np.ndarray:
    """Inverse right Jacobian of SE(3) to second order: I + ad/2 + ad^2/12."""
    ad = _se3_ad(r)
    eye = np.broadcast_to(np.eye(6), ad.shape)
    return eye + 0.5 * ad + (ad @ ad) / 12.0


def _inv44(T: np.ndarray) -> np.ndarray:
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    out = np.zeros_like(T)
    Rt = np.swapaxes(R, -1, -2)
    out[..., :3, :3] = Rt
    out[..., :3, 3] = -np.einsum("...ij,...j->...i", Rt, t)
    out[..., 3, 3] = 1.0
    return out


def refine_global_transforms(
    estimates,
    global_t: list[np.ndarray],
    confidence_threshold: float = 0.0,
    _reject_depth: int = _REJECT_DEPTH,
) -> list[np.ndarray]:
    """Relax all confident pair edges from the spanning-tree seed.

    `estimates`: TransformEstimate list (graph/merge_graph.py); `global_t`:
    the tree-chained seed, whose zero matrices (unregistered maps) pass
    through. The gauge stays at the node seeded with the identity.

    The Huber knee is re-estimated every iteration, clip(3 * median |r|,
    0.01, 0.1), after a graduated start at the 90th percentile; edges far
    from the seed are gated out first, and after convergence gross edges
    (beyond 3 knees and 6 medians) are dropped and the solve repeats, up to
    three rounds, keeping every node attached by its least bad edge."""
    n = len(global_t)
    active = np.array([t[:3, :3].any() for t in global_t])
    if active.sum() < 3:
        return global_t  # the tree on < 3 nodes is exact already

    # confident, successful edges between registered nodes
    edges = [
        e
        for e in estimates
        if e.confidence >= confidence_threshold
        and np.asarray(e.transform)[:3, :3].any()
        and active[e.source_idx]
        and active[e.target_idx]
    ]

    def _seed_residual(e):
        Gs = np.asarray(global_t[e.source_idx], np.float64)
        Gt_ = np.asarray(global_t[e.target_idx], np.float64)
        M = _inv44(Gt_) @ Gs
        D = _inv44(np.asarray(e.transform, np.float64)) @ M
        rot = np.degrees(
            np.arccos(np.clip((np.trace(D[:3, :3]) - 1.0) * 0.5, -1.0, 1.0))
        )
        return rot, float(np.linalg.norm(D[:3, 3]))

    gated = []
    for e in edges:
        rot, trans = _seed_residual(e)
        if rot <= _SEED_GATE_DEG and trans <= _SEED_GATE_M:
            gated.append(e)
    # keep every active node attached
    deg = np.zeros(n, int)
    for e in gated:
        deg[e.source_idx] += 1
        deg[e.target_idx] += 1
    if all(deg[i] > 0 for i in range(n) if active[i]):
        edges = gated

    n_active = int(active.sum())
    if len(edges) <= n_active - 1:
        return global_t  # nothing beyond the tree to relax

    # gauge: the node seeded with the identity, else the first active one
    ref = next(
        (i for i in range(n) if active[i]
         and np.allclose(global_t[i], np.eye(4), atol=1e-6)),
        int(np.argmax(active)),
    )

    G = np.stack([np.asarray(t, np.float64) for t in global_t])  # (N,4,4)
    G[~active] = np.eye(4)  # restored at the end

    src = np.asarray([e.source_idx for e in edges])
    tgt = np.asarray([e.target_idx for e in edges])
    T = np.stack([np.asarray(e.transform, np.float64) for e in edges])
    conf = np.asarray([e.confidence for e in edges], np.float64)
    # information weights: sqrt-compressed confidence, mean 1
    w = np.sqrt(np.maximum(conf, _EPS))
    w /= w.mean()
    # edges flagged ambiguous at registration carry half weight
    amb = np.asarray(
        [bool(getattr(e, "ambiguous", False)) for e in edges]
    )
    if amb.any() and not amb.all():
        w = np.where(amb, 0.5 * w, w)

    def residuals(G):
        # r = log((G_j T)^-1 G_i): zero iff G_i = G_j @ T
        M = _inv44(G[tgt]) @ G[src]  # (E,4,4)
        Z = _inv44(T) @ M
        return se3_log(Z), M

    def knee_of(r):
        rn = np.linalg.norm(r, axis=-1)
        return float(np.clip(3.0 * np.median(rn), 0.01, 0.1))

    def cost_of(r, delta):
        rn = np.linalg.norm(r, axis=-1)
        quad = rn <= delta
        c = np.where(quad, 0.5 * rn**2, delta * (rn - 0.5 * delta))
        return float(np.sum(w * c))

    lam = 1e-6
    r, M = residuals(G)
    delta_h = knee_of(r)
    cost = cost_of(r, delta_h)
    # graduated non-convexity: start with the knee at the 90th percentile
    # and halve it toward the adaptive knee
    gnc0 = float(np.quantile(np.linalg.norm(r, axis=-1), 0.9)) + _EPS
    for it in range(_MAX_ITERATIONS):
        # iteratively reweighted Huber
        delta_h = max(knee_of(r), gnc0 * 0.5**it)
        cost = cost_of(r, delta_h)
        rn = np.linalg.norm(r, axis=-1)
        w_eff = w * np.where(
            rn <= delta_h, 1.0, delta_h / np.maximum(rn, _EPS)
        )

        Jri = _jr_inv(r)  # (E,6,6)
        Ji = Jri
        Jj = -Jri @ _se3_adjoint(_inv44(M))

        # H (6N, 6N) and b (6N) from the 6x6 blocks of every edge
        H = np.zeros((6 * n, 6 * n))
        b = np.zeros(6 * n)
        WJi = w_eff[:, None, None] * Ji
        WJj = w_eff[:, None, None] * Jj
        JiT, JjT = np.swapaxes(Ji, -1, -2), np.swapaxes(Jj, -1, -2)
        Hii = JiT @ WJi
        Hjj = JjT @ WJj
        Hij = JiT @ WJj
        bi = np.einsum("eab,ea->eb", WJi, r)
        bj = np.einsum("eab,ea->eb", WJj, r)
        for e in range(len(edges)):
            i6, j6 = 6 * src[e], 6 * tgt[e]
            H[i6:i6 + 6, i6:i6 + 6] += Hii[e]
            H[j6:j6 + 6, j6:j6 + 6] += Hjj[e]
            H[i6:i6 + 6, j6:j6 + 6] += Hij[e]
            H[j6:j6 + 6, i6:i6 + 6] += Hij[e].T
            b[i6:i6 + 6] += bi[e]
            b[j6:j6 + 6] += bj[e]

        # the gauge node and inactive nodes are pinned
        free = np.ones(n, bool)
        free[ref] = False
        free &= active
        sel = np.repeat(free, 6)
        Hf = H[np.ix_(sel, sel)]
        bf = b[sel]

        # Levenberg damping with an adaptive lambda
        for _try in range(8):
            try:
                delta_f = np.linalg.solve(
                    Hf + lam * np.diag(np.maximum(np.diag(Hf), 1e-12)), -bf
                )
            except np.linalg.LinAlgError:
                lam *= 10.0
                continue
            delta = np.zeros(6 * n)
            delta[sel] = delta_f
            G_new = G @ se3_exp(delta.reshape(n, 6))
            r_new, M_new = residuals(G_new)
            c_new = cost_of(r_new, delta_h)
            if c_new < cost:
                G, r, M, cost = G_new, r_new, M_new, c_new
                lam = max(lam * 0.3, 1e-9)
                break
            lam *= 10.0
        else:
            break  # no damping made progress
        if np.linalg.norm(delta) < _TOL:
            break

    if _reject_depth > 0:
        rn = np.linalg.norm(r, axis=-1)
        gross = rn > np.maximum(3.0 * delta_h, 6.0 * np.median(rn))
        if gross.any() and not gross.all():
            kept = [e for e, g in zip(edges, gross) if not g]
            # a node whose every edge is gross keeps its least bad one
            deg = np.zeros(n, int)
            for e in kept:
                deg[e.source_idx] += 1
                deg[e.target_idx] += 1
            for i in range(n):
                if active[i] and deg[i] == 0:
                    cand = [
                        (rn[k], e)
                        for k, e in enumerate(edges)
                        if e.source_idx == i or e.target_idx == i
                    ]
                    if cand:
                        _, best = min(cand, key=lambda c: c[0])
                        kept.append(best)
                        deg[best.source_idx] += 1
                        deg[best.target_idx] += 1
            if len(kept) < len(edges):
                seeded = [
                    G[i].astype(np.float32) if active[i]
                    else np.zeros((4, 4), np.float32)
                    for i in range(n)
                ]
                return refine_global_transforms(
                    kept, seeded, confidence_threshold, _reject_depth - 1
                )

    return [
        G[i].astype(np.float32) if active[i] else np.zeros((4, 4), np.float32)
        for i in range(n)
    ]
