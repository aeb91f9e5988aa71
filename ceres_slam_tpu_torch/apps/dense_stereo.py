"""Dense photometric stereo alignment.

  python -m ceres_slam_tpu_torch.apps.dense_stereo [--height 120 --width 160]
      [--pose-noise 0.02] [--gt-disparity] [--images LEFT0 RIGHT0 LEFT1]
      [--camera FU FV CU CV B] [--pyrdown 2] [--max-disp 64] [--block 5]
      [--max-iters 40] [--lm-loop device|host] [--match-loop device|host]
      [--pairs 1] [--device cuda]

Port of ``ceres_slam_tpu/apps/dense_stereo.py``, the counterpart of the
reference's ``tests/dense_stereo_test.cpp``: image pair -> semi-global
matching (``frontend/dense_stereo.py``) -> Sobel gradients -> photometric
alignment of the next frame (``solver/photometric.py``). ``--images``
reads real files (``.npy``; png/pgm/jpg need PIL), pyrDowns them
``--pyrdown`` times and aligns from the identity. Without files the app
renders a textured slanted plane seen by a stereo pair and a moved camera,
with ground truth for the error report; ``--gt-disparity`` skips the
matcher and starts from the rendered disparities plus noise.

On the card the alignment's LM loop runs as one conditional WHILE node
with K4 inside (``--lm-loop device``, the default there) and the matcher as
one captured CUDA graph (``--match-loop device``); ``host`` runs either
launch by launch, the CPU's form: the same bits. ``--pairs N`` runs N
synthetic frame pairs in sequence (``run_pairs``): on the card the first
pair captures both, and every later pair copies its inputs into the
captures and restarts the node and replays the matcher (``lm.LMGraph``,
``frontend.dense_stereo.MatcherGraph``).

The random draws are numpy's (``default_rng(seed)``), in the JAX app's
order, so both packages see the same noise. ``main`` returns a stats dict.
The functions run on ``device="cuda"`` unless told otherwise, and raise
without a card (``device="cpu"`` runs them on the CPU).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ceres_slam_tpu_torch.utils.device import resolve


def make_scene(H=120, W=160, seed=0, dtype=torch.float64, stereo=False, device="cuda"):
    """Render a textured slanted plane from two camera poses:
    ``(cam, img_ref, img_trk, gu, gv, disp_ref, T_true)``, plus the frame-0
    RIGHT image with ``stereo=True``. ``seed`` is unused (the scene is
    analytic), as in the JAX package."""
    from ceres_slam_tpu_torch.models.stereo_camera import StereoCamera
    from ceres_slam_tpu_torch.ops import lie, photometric

    device = resolve(device)
    cam = StereoCamera.create(150.0, 150.0, W / 2.0, H / 2.0, 0.5)
    # plane in the ref camera frame: z = z0 + ax x + ay y
    z0, ax, ay = 6.0, 0.15, -0.1

    def tex(x, y):
        return (0.5 + 0.25 * torch.sin(1.7 * x) * torch.cos(2.3 * y)
                + 0.15 * torch.sin(5.1 * x + 3.0 * y) + 0.10 * torch.cos(8.7 * x - 4.1 * y))

    def ray_plane(camdir):
        # p = t * dir; z = z0 + ax x + ay y  =>  t = z0 / (dz - ax dx - ay dy)
        t = z0 / (camdir[..., 2] - ax * camdir[..., 0] - ay * camdir[..., 1])
        return t[..., None] * camdir

    uu, vv = torch.meshgrid(torch.arange(W, dtype=dtype, device=device),
                            torch.arange(H, dtype=dtype, device=device), indexing="xy")
    dirs = torch.stack([(uu - cam.cu) / cam.fu, (vv - cam.cv) / cam.fv, torch.ones_like(uu)],
                       dim=-1)
    p_ref = ray_plane(dirs)  # [H, W, 3] in the ref frame
    img_ref = tex(p_ref[..., 0], p_ref[..., 1])
    disp_ref = cam.fu * cam.b / p_ref[..., 2]

    img_right = None
    if stereo:
        # right camera: offset +b along x, so p_r = p_l - (b, 0, 0); the
        # plane keeps its form with z0' = z0 + ax b, and the texture (a
        # function of LEFT-frame plane coordinates) is read at (x_r + b, y_r)
        z0r = z0 + ax * cam.b
        tr = z0r / (dirs[..., 2] - ax * dirs[..., 0] - ay * dirs[..., 1])
        p_r = tr[..., None] * dirs
        img_right = tex(p_r[..., 0] + cam.b, p_r[..., 1])

    # track camera: small forward + rotation motion; T maps ref -> track
    T_true = lie.se3_exp(torch.tensor([0.05, -0.02, 0.15, 0.004, -0.008, 0.003], dtype=dtype,
                                      device=device))
    T_inv = lie.se3_inverse(T_true)
    R_inv, t_inv = lie.se3_rot(T_inv), lie.se3_trans(T_inv)
    # the track-frame point s * dir lies on the plane: (T^-1 p)_z = z0 +
    # ax (T^-1 p)_x + ay (T^-1 p)_y
    a_vec = R_inv[2] - ax * R_inv[0] - ay * R_inv[1]
    b_sc = z0 + ax * t_inv[0] + ay * t_inv[1] - t_inv[2]
    s = b_sc / torch.einsum("hwi,i->hw", dirs, a_vec)
    p_trk = s[..., None] * dirs
    p_in_ref = lie.se3_transform_point(T_inv, p_trk.reshape(-1, 3)).reshape(H, W, 3)
    img_trk = tex(p_in_ref[..., 0], p_in_ref[..., 1])

    gu, gv = photometric.image_gradients(img_trk)
    if stereo:
        return cam, img_ref, img_trk, gu, gv, disp_ref, T_true, img_right
    return cam, img_ref, img_trk, gu, gv, disp_ref, T_true


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _border_mask(H: int, W: int, border: int) -> np.ndarray:
    uu, vv = np.meshgrid(np.arange(W), np.arange(H))
    return (uu >= border) & (uu < W - border) & (vv >= border) & (vv < H - border)


def _pixel_uv(H: int, W: int) -> np.ndarray:
    uu, vv = np.meshgrid(np.arange(W), np.arange(H))
    return np.stack([uu.reshape(-1), vv.reshape(-1)], axis=-1)


def align_pair(cam, img_ref, img_trk, disp_meas, disp_valid, T_init=None, disp_sigma=0.5,
               border=8, max_iters=40, verbose=True, lm_loop=None, graph=None):
    """Photometric alignment from measured disparities: one residual per
    pixel inside the border with a valid disparity above 0.5 px (the
    reference's problem construction), as one static-shape problem in the
    track image's dtype and on its device. The gradient images are Sobel/8
    of the track image. ``lm_loop``, ``graph``: ``solve_photometric``'s.
    Returns ``(state, summary, problem)``."""
    from ceres_slam_tpu_torch.frontend import dense_stereo as front
    from ceres_slam_tpu_torch.solver import lm
    from ceres_slam_tpu_torch.solver import photometric as ph

    dtype, device = img_trk.dtype, img_trk.device
    H, W = img_ref.shape
    gx, gy = front.sobel_gradients(img_trk)
    disp_np = disp_meas.detach().cpu().numpy().astype(np.float64)
    valid = (_border_mask(H, W, border) & disp_valid.cpu().numpy() & (disp_np > 0.5)).reshape(-1)
    disp0 = torch.as_tensor(np.where(valid, disp_np.reshape(-1), 1.0), dtype=dtype, device=device)
    problem = ph.PhotometricProblem(
        camera=cam, ref_uv=torch.as_tensor(_pixel_uv(H, W), dtype=dtype, device=device),
        ref_intensity=img_ref.reshape(-1).to(dtype), track_img=img_trk, grad_u=gx / 8.0,
        grad_v=gy / 8.0, valid=torch.as_tensor(valid, device=device), disp_meas=disp0,
        disp_stiffness=1.0 / max(disp_sigma, 0.1))
    if T_init is None:
        T_init = torch.cat([torch.zeros(3, dtype=dtype, device=device),
                            torch.eye(3, dtype=dtype, device=device).reshape(9)])
    sol, summary = ph.solve_photometric(problem, ph.PhotometricState(T=T_init, disparities=disp0),
                                        lm.SolveConfig(max_iters=max_iters), lm_loop=lm_loop,
                                        graph=graph)
    if verbose:
        print(f"pixels: {int(valid.sum())} valid / {valid.size}")
        print(f"cost: {summary.initial_cost:.4e} -> {summary.final_cost:.4e} "
              f"in {summary.iterations} iterations")
    return sol, summary, problem


def synthetic_problem(H=120, W=160, seed=0, pose_noise=0.02, disp_noise=0.3, border=8,
                      dtype=torch.float64, device="cuda"):
    """The ``--gt-disparity`` problem: every pixel inside the border, the
    rendered disparities plus N(0, ``disp_noise``) noise as measurements and
    start, the true pose retracted by N(0, ``pose_noise``) noise. Returns
    ``(problem, state0, T_true)``."""
    from ceres_slam_tpu_torch.ops import lie
    from ceres_slam_tpu_torch.solver import photometric as ph

    device = resolve(device)
    rng = np.random.default_rng(seed)
    cam, img_ref, img_trk, gu, gv, disp_ref, T_true = make_scene(H, W, seed, dtype=dtype,
                                                                  device=device)
    sel = _border_mask(H, W, border).reshape(-1)
    idx = torch.as_tensor(np.nonzero(sel)[0], device=device)
    noise = torch.as_tensor(rng.normal(0, disp_noise, idx.numel()), dtype=dtype, device=device)
    disp0 = disp_ref.reshape(-1)[idx] + noise
    problem = ph.PhotometricProblem(
        camera=cam, ref_uv=torch.as_tensor(_pixel_uv(H, W)[sel], dtype=dtype, device=device),
        ref_intensity=img_ref.reshape(-1)[idx], track_img=img_trk, grad_u=gu, grad_v=gv,
        valid=torch.ones(idx.numel(), dtype=torch.bool, device=device), disp_meas=disp0,
        disp_stiffness=1.0 / max(disp_noise, 0.1))
    xi = torch.as_tensor(rng.normal(0, pose_noise, 6), dtype=dtype, device=device)
    state0 = ph.PhotometricState(T=lie.se3_retract(T_true, xi), disparities=disp0)
    return problem, state0, T_true


def _pose_error(T, T_true) -> float:
    from ceres_slam_tpu_torch.ops import lie

    return float(torch.linalg.norm(lie.se3_log(lie.se3_compose(T, lie.se3_inverse(T_true)))))


def _loop_stats(graph0: dict, match0: dict) -> dict:
    """The LM loop's captures and restarts and the matcher's captures since
    the counts ``graph0`` and ``match0`` were taken."""
    from ceres_slam_tpu_torch.frontend import dense_stereo as front
    from ceres_slam_tpu_torch.solver import lm

    return {"lm_graph_captures": lm.GRAPH_STATS["captures"] - graph0["captures"],
            "lm_graph_restarts": lm.GRAPH_STATS["restarts"] - graph0["restarts"],
            "match_graph_captures": front.MATCH_STATS["captures"] - match0["captures"]}


def run(H=120, W=160, seed=0, pose_noise=0.02, disp_noise=0.3, border=8, verbose=True,
        frontend=False, max_disp=48, block=5, max_iters=40, device="cuda", lm_loop=None,
        graph=None, match_loop=None, match_graph=None):
    """Synthetic-scene run in float64. ``frontend=True`` runs the FULL
    chain: rendered stereo pair -> semi-global matching (float32) -> Sobel
    gradients -> alignment; otherwise the rendered disparities plus noise
    are used directly. ``lm_loop``, ``graph``: ``solve_photometric``'s;
    ``match_loop``, ``match_graph``: ``match_disparity``'s ``loop`` and
    ``graph``. Returns ``(summary, err0, err1, stats)`` with the pose errors
    ``|log(T T_true^-1)|`` before and after."""
    from ceres_slam_tpu_torch.frontend import dense_stereo as front
    from ceres_slam_tpu_torch.ops import lie
    from ceres_slam_tpu_torch.solver import lm
    from ceres_slam_tpu_torch.solver import photometric as ph

    device = resolve(device)
    # both switches checked before any work (the matcher runs only with frontend)
    lm_loop = lm.resolve_loop(device, lm_loop)
    match_loop = lm.resolve_loop(device, match_loop, "matcher loop", "match_loop")
    graph0, match0 = dict(lm.GRAPH_STATS), dict(front.MATCH_STATS)
    t0 = time.perf_counter()
    stats = {"matcher_s": 0.0}
    if frontend:
        rng = np.random.default_rng(seed)
        cam, img_ref, img_trk, _, _, disp_gt, T_true, img_right = make_scene(
            H, W, seed, stereo=True, device=device)
        disp, dvalid = front.match_disparity(img_ref.float(), img_right.float(),
                                             max_disp=max_disp, block=block, loop=match_loop,
                                             graph=match_graph)
        m = dvalid.cpu().numpy()
        err = np.abs(disp.cpu().numpy() - disp_gt.cpu().numpy())[m]
        t1 = time.perf_counter()
        stats.update(matcher_s=t1 - t0, matcher_valid_share=float(m.mean()),
                     matcher_median_derr=float(np.median(err)) if err.size else float("nan"))
        if verbose:
            print(f"matcher: {m.mean() * 100:.1f}% valid, median |d_err| "
                  f"{stats['matcher_median_derr']:.3f} px")
        xi = torch.as_tensor(rng.normal(0, pose_noise, 6), dtype=torch.float64, device=device)
        T_init = lie.se3_retract(T_true, xi)
        sol, summary, problem = align_pair(cam, img_ref, img_trk, disp, dvalid, T_init=T_init,
                                           disp_sigma=0.5, border=border, max_iters=max_iters,
                                           verbose=verbose, lm_loop=lm_loop, graph=graph)
    else:
        t1 = t0
        problem, state0, T_true = synthetic_problem(H, W, seed, pose_noise, disp_noise, border,
                                                    device=device)
        T_init = state0.T
        sol, summary = ph.solve_photometric(problem, state0, lm.SolveConfig(max_iters=max_iters),
                                            lm_loop=lm_loop, graph=graph)
        if verbose:
            print(f"pixels: {problem.ref_uv.shape[0]}")
            print(f"cost: {summary.initial_cost:.4e} -> {summary.final_cost:.4e} "
                  f"in {summary.iterations} iterations")
    _sync(device)
    t2 = time.perf_counter()
    err0, err1 = _pose_error(T_init, T_true), _pose_error(sol.T, T_true)
    if verbose:
        print(f"pose error |xi|: {err0:.5f} -> {err1:.5f}")
    stats.update(align_s=t2 - t1, total_s=t2 - t0, pixels_valid=int(problem.valid.sum()),
                 pixels_total=H * W, size=(H, W), T=sol.T.cpu().tolist(),
                 **_loop_stats(graph0, match0))
    return summary, err0, err1, stats


def run_pairs(pairs=2, seed=0, device="cuda", lm_loop=None, match_loop=None, **kw):
    """``pairs`` synthetic frame pairs in sequence: ``run`` with the seeds
    ``seed``, ``seed + 1``, ... and ``run``'s other keywords ``kw``. On the
    card one ``lm.LMGraph`` and one ``MatcherGraph`` serve the sequence:
    the first pair captures the LM loop and the matcher, and every later
    pair copies its inputs into the captures, restarts the node and replays
    the matcher. Returns ``run``'s tuple for each pair."""
    from ceres_slam_tpu_torch.frontend import dense_stereo as front
    from ceres_slam_tpu_torch.solver import lm

    device = resolve(device)
    lm_loop = lm.resolve_loop(device, lm_loop)
    match_loop = lm.resolve_loop(device, match_loop, "matcher loop", "match_loop")
    graph = lm.LMGraph() if lm_loop == "device" else None
    match_graph = front.MatcherGraph() if match_loop == "device" else None
    try:
        return [run(seed=seed + i, device=device, lm_loop=lm_loop, graph=graph,
                    match_loop=match_loop, match_graph=match_graph, **kw) for i in range(pairs)]
    finally:
        for g in (graph, match_graph):
            if g is not None:
                g.close()


def run_images(left0_path, right0_path, left1_path, cam_params, pyrdown=2, max_disp=64,
               block=5, border=8, max_iters=40, verbose=True, device="cuda", lm_loop=None,
               match_loop=None):
    """The reference program's flow on image files: load grayscale, pyrDown
    ``pyrdown`` times (the reference does 2), match frame-0 disparity,
    align frame 1 photometrically from the identity (the switches as
    ``run``'s). Returns ``(state, summary, stats)``."""
    from ceres_slam_tpu_torch.frontend import dense_stereo as front
    from ceres_slam_tpu_torch.models.stereo_camera import StereoCamera
    from ceres_slam_tpu_torch.solver import lm

    device = resolve(device)
    graph0, match0 = dict(lm.GRAPH_STATS), dict(front.MATCH_STATS)
    t0 = time.perf_counter()
    left0, right0, left1 = (front.load_gray(p).to(device)
                            for p in (left0_path, right0_path, left1_path))
    fu, fv, cu, cv, b = cam_params
    for _ in range(pyrdown):
        left0, right0, left1 = front.pyr_down(left0), front.pyr_down(right0), front.pyr_down(left1)
        fu, fv, cu, cv = fu / 2, fv / 2, cu / 2, cv / 2
    cam = StereoCamera.create(fu, fv, cu, cv, b)
    disp, dvalid = front.match_disparity(left0.float(), right0.float(), max_disp=max_disp,
                                         block=block, loop=match_loop)
    share = float(dvalid.float().mean())
    t1 = time.perf_counter()
    if verbose:
        print(f"disparity: {share * 100:.1f}% valid ({left0.shape[0]}x{left0.shape[1]}, "
              f"max_disp {max_disp})")
    sol, summary, problem = align_pair(cam, left0, left1, disp, dvalid, border=border,
                                       max_iters=max_iters, verbose=verbose, lm_loop=lm_loop)
    _sync(device)
    t2 = time.perf_counter()
    if verbose:
        print("Final estimate T_track_ref:")
        print(sol.T.cpu().numpy())
    stats = {"matcher_s": t1 - t0, "align_s": t2 - t1, "total_s": t2 - t0,
             "matcher_valid_share": share, "pixels_valid": int(problem.valid.sum()),
             "pixels_total": problem.valid.numel(), "size": tuple(left0.shape),
             "T": sol.T.cpu().tolist(), **_loop_stats(graph0, match0)}
    return sol, summary, stats


def main(argv=None) -> dict:
    """Run the app; returns the run's sizes, costs, iterations, pose errors
    (when ground truth exists) and walls."""
    from ceres_slam_tpu_torch.apps import common

    p = common.base_parser("dense_stereo: dense disparity + photometric alignment")
    p.set_defaults(max_iters=40)
    p.add_argument("--height", type=int, default=120)
    p.add_argument("--width", type=int, default=160)
    p.add_argument("--pose-noise", type=float, default=0.02)
    p.add_argument("--gt-disparity", action="store_true",
                   help="skip the matcher; use the rendered disparities plus noise")
    p.add_argument("--images", nargs=3, default=None, metavar=("LEFT0", "RIGHT0", "LEFT1"),
                   help="image files (npy; png/pgm/jpg need PIL)")
    p.add_argument("--camera", nargs=5, type=float,
                   default=[721.5377, 721.5377, 609.5593, 172.854, 0.53715],
                   metavar=("FU", "FV", "CU", "CV", "B"),
                   help="full-resolution intrinsics (KITTI defaults)")
    p.add_argument("--pyrdown", type=int, default=2)
    p.add_argument("--max-disp", type=int, default=64)
    p.add_argument("--block", type=int, default=5)
    p.add_argument("--lm-loop", choices=["device", "host"], default=None,
                   help="the alignment's LM loop as a WHILE node on the card (the default "
                        "there) or on the host")
    p.add_argument("--match-loop", choices=["device", "host"], default=None,
                   help="the matcher as one captured CUDA graph on the card (the default "
                        "there) or launch by launch from the host")
    p.add_argument("--pairs", type=int, default=1,
                   help="synthetic frame pairs in sequence (seeds 0, 1, ...), the later ones "
                        "restarting the first pair's captures on the card")
    args = p.parse_args(argv)
    if args.pairs < 1 or (args.images and args.pairs != 1):
        p.error("--pairs takes N >= 1 synthetic pairs (not with --images)")
    with common.traced(args):
        return _run(args)


def _run(args) -> dict:
    """``main`` on its parsed ``args``."""
    from ceres_slam_tpu_torch.apps import common

    loops = dict(lm_loop=args.lm_loop, match_loop=args.match_loop)
    device = common.resolve_device(args.device)

    if args.images:
        _, summary, stats = run_images(*args.images, cam_params=args.camera,
                                       pyrdown=args.pyrdown, max_disp=args.max_disp,
                                       block=args.block, max_iters=args.max_iters, device=device,
                                       **loops)
        runs = [(summary, stats)]
    else:
        runs = [(summary, dict(stats, pose_err0=err0, pose_err1=err1))
                for summary, err0, err1, stats in run_pairs(
                    args.pairs, H=args.height, W=args.width, pose_noise=args.pose_noise,
                    frontend=not args.gt_disparity, max_disp=args.max_disp, block=args.block,
                    max_iters=args.max_iters, device=device, **loops)]
    common.print_reports([summary for summary, _ in runs], args.report)
    for i, (summary, stats) in enumerate(runs):
        stats.update(device=str(device), iterations=summary.iterations,
                     initial_cost=summary.initial_cost, final_cost=summary.final_cost)
        print(f"  {f'pair {i}: ' if len(runs) > 1 else ''}{stats['pixels_valid']} / "
              f"{stats['pixels_total']} pixels, {summary.iterations} LM iterations (LM loop "
              f"captures {stats['lm_graph_captures']}, restarts {stats['lm_graph_restarts']}; "
              f"matcher captures {stats['match_graph_captures']}); matcher "
              f"{stats['matcher_s']:.2f} s, alignment {stats['align_s']:.2f} s, total "
              f"{stats['total_s']:.2f} s on {device}", file=sys.stderr)
    stats = runs[0][1]
    if len(runs) > 1:
        stats["later_pairs"] = [st for _, st in runs[1:]]
    return stats


if __name__ == "__main__":
    main()
