"""Stage-by-stage registration debugger (port of
mapmerge_tpu/tools/registration_visualisation.py).

The reference's registration_visualisation tool
(src/registration_visualisation.cpp:22-174): run the 2-cloud pipeline one
stage at a time with per-stage wall-clock timings (the pcl::ScopeTime
analog, `utils/profiling.StageTimes`), point/keypoint/correspondence counts
and scores printed after each stage, BOTH estimation methods compared, and
an ICP-refined final result.

Instead of interactive PCL viewer windows (unavailable headless), each
stage can dump its intermediate cloud as a .pcd into --dump-dir for offline
inspection, and --render DIR writes PNG renders of the five reference
views (cloud, normals, keypoints, correspondence lines, aligned overlay —
visualise.cpp:20-95) via tools/render.py, which needs matplotlib: without
it --render fails before any stage runs. RANSAC and SAC-IA draw from
generators seeded with 0 and 1, where the JAX tool takes JAX keys 0 and 1.

Usage:
  python -m mapmerge_torch.tools.registration_visualisation a.pcd b.pcd \\
      [--param value ...] [--dump-dir DIR] [--render DIR]
"""

from __future__ import annotations

import os
import sys

import numpy as np

from mapmerge_torch.core.device import resolve


def main(argv: list[str] | None = None, *, device=None) -> int:
    """Run the tool; `device` is where it runs (the current CUDA device when
    None; raises without a card)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    pcd_files = [a for a in argv if a.endswith(".pcd")]
    if len(pcd_files) != 2:
        print(
            "usage: registration_visualisation map1.pcd map2.pcd "
            "[--param value ...] [--dump-dir DIR]",
            file=sys.stderr,
        )
        return 1
    device = resolve(device)
    dump_dir = None
    if "--dump-dir" in argv:
        dump_dir = argv[argv.index("--dump-dir") + 1]
        os.makedirs(dump_dir, exist_ok=True)
    render_dir = None
    if "--render" in argv:
        from mapmerge_torch.tools import render as rnd

        rnd.require_matplotlib()
        render_dir = argv[argv.index("--render") + 1]
        os.makedirs(render_dir, exist_ok=True)

    from mapmerge_torch.core import transforms as tf
    from mapmerge_torch.core.cloud import PointCloud
    from mapmerge_torch.core.params import MergeParams
    from mapmerge_torch.io.pcd import read_pcd_arrays, write_pcd
    from mapmerge_torch.ops.descriptors import compute_descriptors
    from mapmerge_torch.ops.downsample import voxel_downsample
    from mapmerge_torch.ops.icp import icp_refine
    from mapmerge_torch.ops.keypoints import detect_keypoints
    from mapmerge_torch.ops.matching import find_correspondences
    from mapmerge_torch.ops.normals import compute_surface_normals
    from mapmerge_torch.ops.outliers import remove_outliers
    from mapmerge_torch.ops.ransac import ransac_transform
    from mapmerge_torch.ops.sacia import sacia_transform
    from mapmerge_torch.ops.score import transform_score
    from mapmerge_torch.pipeline.merging import seeded_generator
    from mapmerge_torch.utils.profiling import StageTimes

    params = MergeParams.from_command_line(argv)
    print(params)
    timer = StageTimes(device)

    def dump(name: str, cloud: PointCloud):
        if dump_dir:
            write_pcd(os.path.join(dump_dir, name + ".pcd"), cloud)

    def host(t) -> np.ndarray:
        return t.cpu().numpy()

    clouds = []
    for path in pcd_files:
        xyz, rgb = read_pcd_arrays(path)
        clouds.append(PointCloud.from_numpy(xyz, rgb, device=device))
        print(f"loaded {path}: {len(xyz)} points")

    stages = {}
    for i, cloud in enumerate(clouds):
        tag = f"map{i}"
        with timer.stage(f"{tag}/downsample"):
            resized = voxel_downsample(cloud, params.resolution)
        print(f"  {tag} downsampled: {int(resized.count)} points")
        dump(f"{tag}_downsampled", resized)

        with timer.stage(f"{tag}/remove_outliers"):
            inliers = remove_outliers(
                resized,
                params.descriptor_radius,
                params.outliers_min_neighbours,
                tile=params.neighbor_tile,
            )
        print(f"  {tag} after outlier removal: {int(inliers.count)} points")
        dump(f"{tag}_inliers", inliers)

        with timer.stage(f"{tag}/normals"):
            normals = compute_surface_normals(
                inliers, params.normal_radius, tile=params.neighbor_tile
            )
        print(f"  {tag} normals valid: {int(normals.valid.sum())}")

        with timer.stage(f"{tag}/keypoints"):
            keypoints = detect_keypoints(
                inliers,
                normals,
                params.keypoint_type,
                threshold=params.keypoint_threshold,
                radius=params.normal_radius,
                resolution=params.resolution,
                max_keypoints=params.max_keypoints,
                tile=params.neighbor_tile,
                sift_octaves=params.sift_octaves,
                sift_scales_per_octave=params.sift_scales_per_octave,
            )
        print(f"  {tag} keypoints: {int(keypoints.mask.sum())}")
        if dump_dir:
            kx = host(keypoints.xyz)[host(keypoints.mask)]
            write_pcd(
                os.path.join(dump_dir, f"{tag}_keypoints.pcd"),
                (kx, np.tile([1.0, 0.0, 0.0], (len(kx), 1))),
            )

        with timer.stage(f"{tag}/descriptors"):
            descriptors = compute_descriptors(
                inliers,
                normals,
                keypoints,
                params.descriptor_type,
                params.descriptor_radius,
                max_neighbors=params.max_neighbors,
                tile=params.neighbor_tile,
            )
        print(
            f"  {tag} descriptors: {int(descriptors.valid.sum())} valid, "
            f"dim {descriptors.data.shape[1]} ({params.descriptor_type})"
        )
        stages[i] = (inliers, normals, keypoints, descriptors)

        if render_dir:
            xyz_np, rgb_np = inliers.to_numpy()
            paths = [
                rnd.render_cloud(
                    os.path.join(render_dir, f"{tag}_cloud.png"),
                    xyz_np, rgb_np, title=f"{tag} cloud",
                ),
                rnd.render_normals(
                    os.path.join(render_dir, f"{tag}_normals.png"),
                    host(inliers.xyz),
                    host(normals.normals),
                    valid=host(normals.valid & inliers.mask),
                    title=f"{tag} normals",
                ),
                rnd.render_keypoints(
                    os.path.join(render_dir, f"{tag}_keypoints.png"),
                    xyz_np, host(keypoints.xyz),
                    kp_mask=host(keypoints.mask),
                    title=f"{tag} keypoints",
                ),
            ]
            for p in paths:
                print(f"  rendered {p}")

    (c0, n0, k0, d0), (c1, n1, k1, d1) = stages[0], stages[1]

    # --- MATCHING path (matching.cpp:117-137 analog) ---
    with timer.stage("matching/correspondences"):
        corr = find_correspondences(
            d0.data, d1.data, params.matching_k,
            source_valid=d0.valid & k0.mask,
            target_valid=d1.valid & k1.mask,
        )
    print(f"  correspondences: {int(corr.valid.sum())}")

    with timer.stage("matching/ransac"):
        res = ransac_transform(
            k0.xyz, k1.xyz, corr,
            inlier_threshold=params.inlier_threshold,
            num_hypotheses=params.ransac_hypotheses,
            generator=seeded_generator([0], device),
        )
    score_m, cov_m, _ = transform_score(
        c0, c1, res.transform, params.max_correspondence_distance,
    )
    print(
        f"  RANSAC: ok={bool(res.ok)} inliers={int(res.inlier_count)} "
        f"score={float(score_m):.6f} coverage={float(cov_m):.2f}"
    )
    print(np.array2string(host(res.transform), precision=4))

    if render_dir:
        valid_np = host(corr.valid)
        src_idx = np.nonzero(valid_np)[0]
        pairs = np.stack([src_idx, host(corr.target)[src_idx]], axis=1)
        p = rnd.render_correspondences(
            os.path.join(render_dir, "correspondences.png"),
            host(k0.xyz), host(k1.xyz), pairs,
            inlier_mask=host(res.inliers)[src_idx],
        )
        print(f"  rendered {p}")

    # --- SAC-IA path for comparison (matching.cpp:139-154 analog) ---
    with timer.stage("sacia"):
        t_sac, ok_sac, inl_sac = sacia_transform(
            k0, d0, k1, d1,
            min_sample_distance=params.inlier_threshold,
            max_correspondence_distance=params.max_correspondence_distance,
            num_iterations=params.sacia_hypotheses,
            generator=seeded_generator([1], device),
        )
    score_s, cov_s, _ = transform_score(
        c0, c1, t_sac, params.max_correspondence_distance,
    )
    print(
        f"  SAC-IA: ok={bool(ok_sac)} inliers~{int(inl_sac)} "
        f"score={float(score_s):.6f} coverage={float(cov_s):.2f}"
    )

    # --- ICP refinement of the MATCHING result (matching.cpp:156-171) ---
    with timer.stage("icp"):
        refined, icp_ok, _ = icp_refine(
            c0, c1, res.transform,
            max_correspondence_distance=params.max_correspondence_distance,
            outlier_rejection_threshold=params.inlier_threshold,
            max_iterations=params.max_iterations,
            transform_epsilon=params.transform_epsilon,
            min_correspondence_distance=params.resolution,
        )
    score_i, cov_i, _ = transform_score(
        c0, c1, refined, params.max_correspondence_distance,
    )
    print(
        f"  ICP refined: ok={bool(icp_ok)} score={float(score_i):.6f} "
        f"coverage={float(cov_i):.2f}"
    )
    print(np.array2string(host(refined), precision=4))

    if render_dir:
        moved_xyz = host(tf.apply(refined, c0.xyz))[host(c0.mask)]
        p = rnd.render_alignment(
            os.path.join(render_dir, "aligned_overlay.png"),
            moved_xyz, host(c1.xyz)[host(c1.mask)],
        )
        print(f"  rendered {p}")

    if dump_dir:
        ax = host(tf.apply(refined, c0.xyz))[host(c0.mask)]
        bx, _ = c1.to_numpy()
        write_pcd(
            os.path.join(dump_dir, "aligned_overlay.pcd"),
            (
                np.concatenate([ax, bx]),
                np.concatenate(
                    [
                        np.tile([1.0, 0.3, 0.3], (len(ax), 1)),
                        np.tile([0.3, 0.3, 1.0], (len(bx), 1)),
                    ]
                ),
            ),
        )
        print(f"stage dumps written to {dump_dir}")

    total = sum(timer.times.values())
    print(f"total: {total * 1000.0:.1f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
