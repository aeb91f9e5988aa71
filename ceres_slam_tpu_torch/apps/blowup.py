"""Covariance blow-up experiment.

  python -m ceres_slam_tpu_torch.apps.blowup [--num-poses 1000] [--device cuda]

Port of ``ceres_slam_tpu/apps/blowup.py`` (the reference's
``tests/blowup_test.cpp``): chain ``num_poses`` relative-pose measurements
(10 cm forward a step, covariance 1e-3 I), solve each 2-pose problem with
a prior from the previous step's covariance, and compare the solver's
tangent covariance of the new pose with the closed-form propagation

    Sigma_2 = Sigma_meas + Ad(T_meas) Sigma_1 Ad(T_meas)^T.

The JAX app runs the chain as one ``lax.scan``; here it is a host loop of
2-pose solves (``max_iters=20``), each followed by
``pose_graph.pose_graph_covariance``. Every step has the same structure,
so its gather tables are built once.
"""

from __future__ import annotations

import numpy as np
import torch


def run(num_poses: int = 1000, verbose: bool = True, device="cuda"):
    """Returns numpy ``(covs [n-1, 6, 6], manuals [n-1, 6, 6], rel_err
    [n-1])``: the solver's and the closed form's covariance of each new
    pose, and their max relative deviation per step."""
    from ceres_slam_tpu_torch.ops import factors, lie
    from ceres_slam_tpu_torch.solver import lm, pose_graph
    from ceres_slam_tpu_torch.utils import device as device_mod

    dev = device_mod.resolve(device)
    f64 = dict(dtype=torch.float64, device=dev)
    meas = lie.se3_make(torch.tensor([0.1, 0.0, 0.0], **f64), torch.eye(3, **f64))
    meas_covar = 1e-3 * torch.eye(6, **f64)
    Ad = lie.se3_adjoint(meas)
    zero, one = torch.zeros(1, dtype=torch.int64, device=dev), torch.ones(1, dtype=torch.int64,
                                                                          device=dev)
    yes = torch.ones(1, dtype=torch.bool, device=dev)
    rel = pose_graph.RelPoseFactors(idx1=zero, idx2=one, T_ref=meas[None],
                                    stiffness=factors.inv_sqrt_psd(meas_covar)[None], valid=yes)

    def make_problem(T1, prior_stiffness):
        priors = pose_graph.PriorFactors(idx=zero, T_ref=T1[None], stiffness=prior_stiffness[None],
                                         valid=yes)
        return pose_graph.PoseGraphProblem(rel=rel, priors=priors,
                                           fixed_pose_mask=torch.zeros(2, dtype=torch.bool,
                                                                       device=dev))

    T1 = lie.se3_identity(dtype=torch.float64, device=dev).clone()
    covar1 = 1e-12 * torch.eye(6, **f64)
    tables = pose_graph.pose_graph_tables(make_problem(T1, covar1))
    config = lm.SolveConfig(max_iters=20)
    covs, manuals = [], []
    for _ in range(num_poses - 1):
        problem = make_problem(T1, factors.inv_sqrt_psd(covar1))
        # the new pose starts at the previous one (blowup_test.cpp:61)
        poses, _ = pose_graph.solve_pose_graph(problem, torch.stack([T1, T1]), config, tables)
        covar2 = pose_graph.pose_graph_covariance(problem, poses, 1, tables)
        manuals.append(meas_covar + Ad @ covar1 @ Ad.T)
        covs.append(covar2)
        T1, covar1 = poses[1], covar2
    covs = torch.stack(covs).cpu().numpy()
    manuals = torch.stack(manuals).cpu().numpy()
    rel_err = np.abs(covs - manuals).max(axis=(1, 2)) / np.abs(manuals).max(axis=(1, 2))
    if verbose:
        print(f"Solver covariance for k={num_poses - 1}:\n{covs[-1]}")
        print(f"Manual covariance for k={num_poses - 1}:\n{manuals[-1]}")
        print(f"max relative deviation over chain: {rel_err.max():.3e}")
    return covs, manuals, rel_err


def main(argv=None):
    from ceres_slam_tpu_torch.apps.common import base_parser, resolve_device

    p = base_parser("blowup: covariance propagation experiment")
    p.add_argument("--num-poses", type=int, default=1000)
    args = p.parse_args(argv)
    return run(args.num_poses, device=resolve_device(args.device))


if __name__ == "__main__":
    main()
