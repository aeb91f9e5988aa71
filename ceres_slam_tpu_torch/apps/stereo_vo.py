"""Live stereo visual-odometry app: images in, trajectory out.

  python -m ceres_slam_tpu_torch.apps.stereo_vo --out BASE
      (--left-glob 'L*.npy' --right-glob 'R*.npy' | --synthetic N)
      [--fu 140 --fv 140 --cu 80 --cv 60 --baseline 0.4] [--max-corners 384]
      [--ransac-iters 400] [--ransac-thresh 4.0] [--device cuda]
      [--frame-loop device|host]

Port of ``ceres_slam_tpu/apps/stereo_vo.py`` (the CLI counterpart of the
reference's ROS node): runs ``frontend/stereo_vo.OnlineStereoVO`` over a
sequence of rectified stereo pairs and writes ``<out>_poses.csv`` (4x4
row-major, the reference format). Input modes: ``--left-glob`` /
``--right-glob``, sorted patterns of grayscale frames (``.npy`` arrays, or
``.png``/``.pgm``/``.jpg`` through PIL, imported only then); or
``--synthetic N``, N rendered frames of a textured plane along a known
trajectory, with the ATE against it. ``--device`` defaults to ``cuda`` and
exits without a card (``--device cpu`` runs on the CPU). ``--frame-loop``:
``device`` (the default on the card) replays every tracked frame's
captured graphs (``frontend/stereo_vo.FrameGraph``: two graphs around the
eager SVD), ``host`` (the default elsewhere; ``device`` there raises)
launches a frame's kernels one by one; both write the same poses. The
stats report the form, the graphs' capture and instantiation seconds and
the frames per second.
"""

from __future__ import annotations

import glob as globmod
import math
import sys
import time

import numpy as np
import torch


def _load_gray(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        img = np.load(path)
    else:
        try:
            from PIL import Image
        except ImportError as e:
            raise SystemExit(f"cannot read {path}: PIL unavailable; use .npy frames") from e
        img = np.asarray(Image.open(path).convert("L"), np.float64) / 255.0
    if img.ndim == 3:
        img = img.mean(-1)
    return np.asarray(img, np.float64)


def _render_synthetic(camera, n_frames: int, shape=(120, 160), z0: float = 8.0, device="cuda"):
    """A textured-plane stereo sequence (the wall ``z_w = z0``) along a
    sideways and forward dolly, float64 on ``device``. Returns ``(frames
    [(left, right)], gt_poses [N, 12] T_c_w numpy)``."""
    from ceres_slam_tpu_torch.ops import lie
    from ceres_slam_tpu_torch.utils import device as device_mod

    dev = device_mod.resolve(device)
    H, W = shape
    f64 = dict(dtype=torch.float64, device=dev)

    def tex(x, y):
        return (0.5 + 0.2 * torch.sin(1.3 * x) * torch.cos(1.9 * y)
                + 0.15 * torch.sin(4.1 * x + 2.0 * y) + 0.1 * torch.cos(7.3 * x - 3.1 * y)
                + 0.05 * torch.sin(13.0 * x * y / 4.0))

    vv, uu = torch.meshgrid(torch.arange(H, **f64), torch.arange(W, **f64), indexing="ij")
    dirs = torch.stack([(uu - camera.cu) / camera.fu, (vv - camera.cv) / camera.fv,
                        torch.ones_like(uu)], dim=-1)

    def render(T_c_w):
        T_w_c = lie.se3_inverse(T_c_w)
        R_wc, c_w = lie.se3_rot(T_w_c), lie.se3_trans(T_w_c)

        def from_center(c):
            d_w = torch.einsum("ij,hwj->hwi", R_wc, dirs)
            s = (z0 - c[2]) / d_w[..., 2]
            p_w = c + s[..., None] * d_w
            return tex(p_w[..., 0], p_w[..., 1])

        right_c = c_w + R_wc @ torch.tensor([float(camera.b), 0.0, 0.0], **f64)
        return from_center(c_w), from_center(right_c)

    frames, gt = [], []
    for i in range(n_frames):
        xi = torch.tensor([0.03 * i, 0.01 * math.sin(0.2 * i), 0.02 * i, 0.0, 0.002 * i, 0.0],
                          **f64)
        T_c_w = lie.se3_exp(xi)
        frames.append(render(T_c_w))
        gt.append(T_c_w.cpu().numpy())
    return frames, np.stack(gt)


def build_parser():
    from ceres_slam_tpu_torch.apps.common import base_parser

    p = base_parser("stereo_vo: online stereo visual odometry from images")
    p.add_argument("--left-glob", default=None,
                   help="sorted glob of left rectified frames (.npy/.png)")
    p.add_argument("--right-glob", default=None, help="sorted glob of right rectified frames")
    p.add_argument("--synthetic", type=int, default=0, metavar="N",
                   help="render an N-frame synthetic sequence instead of files")
    p.add_argument("--out", required=True, help="output base: writes <out>_poses.csv")
    p.add_argument("--fu", type=float, default=140.0)
    p.add_argument("--fv", type=float, default=140.0)
    p.add_argument("--cu", type=float, default=80.0)
    p.add_argument("--cv", type=float, default=60.0)
    p.add_argument("--baseline", type=float, default=0.4)
    p.add_argument("--max-corners", type=int, default=384)
    p.add_argument("--ransac-iters", type=int, default=400)
    p.add_argument("--ransac-thresh", type=float, default=4.0,
                   help="squared-pixel inlier threshold (node default)")
    p.add_argument("--frame-loop", choices=["device", "host"], default=None,
                   help="a tracked frame as captured CUDA graphs (device, the default on the "
                        "card) or launch by launch (host, the default elsewhere)")
    return p


def main(argv=None) -> dict:
    """Run the app; returns the run's counts and walls."""
    args = build_parser().parse_args(argv)
    from ceres_slam_tpu_torch.apps import common

    with common.traced(args):
        return _run(args)


def _run(args) -> dict:
    """``main`` on its parsed ``args``."""
    from ceres_slam_tpu_torch.apps.common import resolve_device
    from ceres_slam_tpu_torch.frontend.stereo_vo import FRAME_STATS, OnlineStereoVO
    from ceres_slam_tpu_torch.models.stereo_camera import StereoCamera
    from ceres_slam_tpu_torch.utils import csvio, metrics

    device = resolve_device(args.device)
    camera = StereoCamera.create(args.fu, args.fv, args.cu, args.cv, args.baseline)
    gt = None
    if args.synthetic:
        frames, gt = _render_synthetic(camera, args.synthetic, device=device)
    else:
        if not (args.left_glob and args.right_glob):
            raise SystemExit("need --left-glob/--right-glob or --synthetic N")
        lefts, rights = sorted(globmod.glob(args.left_glob)), sorted(globmod.glob(args.right_glob))
        if len(lefts) != len(rights) or not lefts:
            raise SystemExit(f"frame count mismatch: {len(lefts)} left vs {len(rights)} right")
        frames = ((_load_gray(l), _load_gray(r)) for l, r in zip(lefts, rights))

    vo = OnlineStereoVO(camera, max_corners=args.max_corners, ransac_iters=args.ransac_iters,
                        ransac_thresh=args.ransac_thresh, device=device,
                        frame_loop=args.frame_loop)
    graphs0 = dict(FRAME_STATS)
    t0 = time.perf_counter()
    n = 0
    try:
        for left, right in frames:
            vo.process(left, right)
            n += 1
            if n % 25 == 0:
                print(f"  frame {n} done", file=sys.stderr)
        traj = torch.stack(vo.trajectory[1:]).cpu().numpy()  # drop the pre-frame identity
    finally:
        vo.close()
    wall = time.perf_counter() - t0
    counts = torch.stack(vo.counts).cpu().numpy()
    print(f"Processed {n} frames in {wall:.3f} s ({n / wall:.2f} frames/s, frame loop "
          f"{vo.frame_loop})", file=sys.stderr)
    csvio.write_poses_csv(args.out + "_poses.csv", traj)
    print(f"Wrote {args.out}_poses.csv", file=sys.stderr)
    stats = {"device": str(device), "frames": n, "wall_s": wall, "frames_per_s": n / wall,
             "frame_loop": vo.frame_loop,
             "captures": FRAME_STATS["captures"] - graphs0["captures"],
             "capture_s": FRAME_STATS["capture_s"] - graphs0["capture_s"],
             "instantiate_s": FRAME_STATS["instantiate_s"] - graphs0["instantiate_s"],
             "poses": args.out + "_poses.csv",
             "median_corners": float(np.median(counts[:, 0])),
             "median_stereo_matches": float(np.median(counts[:, 1])),
             "median_temporal_matches": float(np.median(counts[1:, 2])) if n > 1 else 0.0}
    if gt is not None:
        stats["ate"] = metrics.ate_translation(traj, gt)
        stats["max_rot_err_deg"] = float(metrics.rotation_error_deg(traj, gt).max())
        print(f"synthetic ATE RMSE: {stats['ate']:.4f} m, max rot err: "
              f"{stats['max_rot_err_deg']:.3f} deg")
    return stats


if __name__ == "__main__":
    main()
