"""Sim dataset generator CLI (port of ``ceres_slam_tpu/apps/make_sim.py``):

  python -m ceres_slam_tpu_torch.apps.make_sim out_dir --kind triangle \\
      --num-states 200 --sun-noise 0 10 20 30
  python -m ceres_slam_tpu_torch.apps.make_sim out_dir --kind phong \\
      --num-states 200 --num-points 1000 [--num-materials 3] [--directional]
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser(description="generate sim sequences")
    p.add_argument("out_dir")
    p.add_argument("--kind", default="triangle",
                   choices=["triangle", "square", "penta", "circle", "kitti", "phong"],
                   help="'kitti' generates a KITTI-shaped street drive "
                        "(open trajectory, corridor landmarks, tracker-style tracks); "
                        "'phong' a Phong-shaded track for dataset_ba_phong (vertex "
                        "normals and intensities, shared materials, a point light)")
    p.add_argument("--num-states", type=int, default=200)
    p.add_argument("--num-points", type=int, default=None,
                   help="default: 400 (polygon sims) or 16 per state (kitti)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sun-noise", type=float, nargs="*", default=[0.0, 10.0, 20.0, 30.0],
                   help="sun observation noise levels in degrees (one obs file per level)")
    p.add_argument("--num-materials", type=int, default=3,
                   help="shared-material count (phong kind only)")
    p.add_argument("--directional", action="store_true",
                   help="directional instead of point light (phong kind)")
    args = p.parse_args(argv)

    from ceres_slam_tpu_torch.utils import sim

    os.makedirs(args.out_dir, exist_ok=True)
    name = f"{args.kind}{args.num_states}"
    base = os.path.join(args.out_dir, name)
    if args.num_points is None:
        args.num_points = 16 * args.num_states if args.kind == "kitti" else 400
    if args.kind == "phong":
        ds = sim.generate_phong(num_states=args.num_states, num_points=args.num_points,
                                num_materials=args.num_materials, seed=args.seed,
                                directional=args.directional)
        sim.write_phong_track_csv(ds, base + ".csv")
        sim.write_gt_poses_csv(ds, base + "_gt_poses.csv")
        print(f"wrote {name} dataset to {args.out_dir}")
        return

    def gen(noise):
        if args.kind == "kitti":
            return sim.generate_kitti(num_states=args.num_states, num_points=args.num_points,
                                      seed=args.seed, sun_noise_deg=noise)
        return sim.generate(kind=args.kind, num_states=args.num_states,
                            num_points=args.num_points, seed=args.seed, sun_noise_deg=noise)

    ds = gen(0.0)
    sim.write_track_csv(ds, base + ".csv", with_covar=True)
    sim.write_track_csv(ds, base + "_vo.csv", with_covar=False)
    sim.write_ref_sun_csv(ds, base + "_sun_ref.csv")
    sim.write_gt_poses_csv(ds, base + "_gt_poses.csv")
    for noise in args.sun_noise:
        sim.write_obs_sun_csv(gen(noise), base + f"_sun_dir_gtsun{int(noise)}.csv")
    print(f"wrote {name} dataset to {args.out_dir}")


if __name__ == "__main__":
    main()
