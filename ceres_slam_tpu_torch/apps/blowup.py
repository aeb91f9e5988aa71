"""Covariance blow-up experiment.

  python -m ceres_slam_tpu_torch.apps.blowup [--num-poses 1000] [--device cuda]
      [--chain-loop device|host]

Port of ``ceres_slam_tpu/apps/blowup.py`` (the reference's
``tests/blowup_test.cpp``): chain ``num_poses`` relative-pose measurements
(10 cm forward a step, covariance 1e-3 I), solve each 2-pose problem with
a prior from the previous step's covariance, and compare the solver's
tangent covariance of the new pose with the closed-form propagation

    Sigma_2 = Sigma_meas + Ad(T_meas) Sigma_1 Ad(T_meas)^T.

The JAX app runs the chain as one ``lax.scan``. Here one step of the chain
is ``make_chain``'s body: the prior whitened by the Cholesky factor of the
last covariance (``factors.chol_whiten``) and written with the last pose
into the prior's tensors, both poses started at the last pose
(``blowup_test.cpp:61``), the 2-pose LM solve (``max_iters=20``, through
``lm.inner_lm``), the covariance of the new pose, the closed form, both
written at the step's row, and the carry. On the card the chain runs as one
conditional WHILE node with each step's LM loop a WHILE node nested in it
(``--chain-loop device``, the default there): one graph launch for the
chain and one read of its buffers at the end. ``--chain-loop host`` (the
CPU's form) iterates the same body on the host, the chain's test and the
LM loop's read every iteration: the same bits. Every step has the same
structure, so its gather tables are built once.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple

import numpy as np
import torch


class Chain(NamedTuple):
    """The chain's buffers and its body: ``body()`` runs one step in place
    and writes the chain's test to ``pred`` (int32, 1: run again)."""

    body: Callable[[], None]
    pred: torch.Tensor  # int32 [1]
    step: torch.Tensor  # int32 [1], the steps run
    covs: torch.Tensor  # [n-1, 6, 6] the solver's covariance of each new pose
    manuals: torch.Tensor  # [n-1, 6, 6] the closed form's
    iterations: torch.Tensor  # int32 [n-1] each step's LM iterations


def make_chain(num_poses: int, device) -> Chain:
    """The chain of ``num_poses`` poses on ``device``: every tensor its body
    reads or writes is allocated here, so a capture of the body reads them
    by address."""
    from ceres_slam_tpu_torch.ops import factors, lie
    from ceres_slam_tpu_torch.solver import lm, pose_graph

    n = num_poses - 1
    if n < 1:
        raise ValueError(f"a chain needs at least 2 poses, got {num_poses}")
    f64 = dict(dtype=torch.float64, device=device)
    meas = lie.se3_make(torch.tensor([0.1, 0.0, 0.0], **f64), torch.eye(3, **f64))
    meas_covar = 1e-3 * torch.eye(6, **f64)
    Ad = lie.se3_adjoint(meas)
    zero, one = (torch.full((1,), i, dtype=torch.int64, device=device) for i in (0, 1))
    yes = torch.ones(1, dtype=torch.bool, device=device)
    # the carry, and the prior's tensors that each step rewrites
    T1 = lie.se3_identity(dtype=torch.float64, device=device).clone()
    covar1 = 1e-12 * torch.eye(6, **f64)
    prior_T, prior_S = T1[None].clone(), factors.chol_whiten(covar1)[None]
    problem = pose_graph.PoseGraphProblem(
        rel=pose_graph.RelPoseFactors(idx1=zero, idx2=one, T_ref=meas[None],
                                      stiffness=factors.inv_sqrt_psd(meas_covar)[None],
                                      valid=yes),
        priors=pose_graph.PriorFactors(idx=zero, T_ref=prior_T, stiffness=prior_S, valid=yes),
        fixed_pose_mask=torch.zeros(2, dtype=torch.bool, device=device))
    tables = pose_graph.pose_graph_tables(problem)
    poses0 = T1.expand(2, 12).clone()
    lp = lm.lm_loop(poses0, lm.SolveConfig(max_iters=20), *pose_graph.lm_functions(problem, tables))
    step = torch.zeros(1, dtype=torch.int32, device=device)
    pred = (step < n).to(torch.int32)
    covs, manuals = torch.zeros((n, 6, 6), **f64), torch.zeros((n, 6, 6), **f64)
    iterations = torch.zeros(n, dtype=torch.int32, device=device)

    def body():
        prior_S.copy_(factors.chol_whiten(covar1)[None])
        prior_T.copy_(T1[None])
        poses0.copy_(T1.expand(2, 12))  # the new pose starts at the previous one
        lm.inner_lm(lp)
        poses = lp.carry.state
        covar2 = pose_graph.pose_graph_covariance(problem, poses, 1, tables)
        row = step.long()
        covs.index_copy_(0, row, covar2[None])
        manuals.index_copy_(0, row, (meas_covar + Ad @ covar1 @ Ad.T)[None])
        iterations.index_copy_(0, row, lp.carry.it.reshape(1))
        T1.copy_(poses[1])
        covar1.copy_(covar2)
        step.add_(1)
        pred.copy_(step < n)

    return Chain(body, pred, step, covs, manuals, iterations)


def _read(ch: Chain) -> np.ndarray:
    """The chain's buffers in one copy to the host: the covariances, the
    closed forms, each step's LM iterations and the steps run."""
    f64 = torch.float64
    return torch.cat([ch.covs.reshape(-1), ch.manuals.reshape(-1), ch.iterations.to(f64),
                      ch.step.to(f64)]).cpu().numpy()


def run_chain(num_poses: int = 1000, device="cuda", chain_loop: str | None = None):
    """Run the chain; returns numpy ``(covs [n-1, 6, 6], manuals [n-1, 6,
    6], iterations [n-1])`` and the run's stats (the chain's steps, the LM
    iterations in total, the captures, the wall and solves/s, and the
    node's device ms by CUDA events: every step but the first).
    ``chain_loop``: ``"device"`` (the default on CUDA) runs the chain as
    one WHILE node, its first step eagerly before the capture (it makes the
    libraries' handles); ``"host"`` (the default elsewhere) iterates the
    same body on the host. The device loop off the card raises."""
    from ceres_slam_tpu_torch.ops import graph_loop
    from ceres_slam_tpu_torch.solver import lm
    from ceres_slam_tpu_torch.utils import device as device_mod

    dev = device_mod.resolve(device)
    loop = lm.resolve_loop(dev, chain_loop, "chain loop", "chain_loop")
    t0 = time.perf_counter()
    ch = make_chain(num_poses, dev)
    captures, capture_s, node_ms = 0, 0.0, None
    if loop == "device":
        stream = graph_loop.capture_stream(ch.pred.get_device())
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            if bool(ch.pred):
                ch.body()  # the first step, eagerly
        torch.cuda.current_stream().wait_stream(stream)
        node = graph_loop.DeviceWhile(ch.body, ch.pred)
        captures, capture_s = 1, node.capture_s + node.build_s
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        try:
            start.record()
            node.launch()
            end.record()
            out = _read(ch)
        finally:
            node.close()
        node_ms = start.elapsed_time(end)
    else:
        while int(ch.pred[0]):
            ch.body()
        out = _read(ch)
    wall = time.perf_counter() - t0
    n = num_poses - 1
    covs, manuals = out[:36 * n].reshape(n, 6, 6), out[36 * n:72 * n].reshape(n, 6, 6)
    iterations = out[72 * n:73 * n].astype(np.int64)
    stats = {"chain_loop": loop, "steps": int(out[-1]), "lm_iterations": int(iterations.sum()),
             "captures": captures, "capture_s": capture_s, "node_ms": node_ms, "wall_s": wall,
             "solves_per_s": n / wall}
    return covs, manuals, iterations, stats


def run(num_poses: int = 1000, verbose: bool = True, device="cuda",
        chain_loop: str | None = None):
    """Returns numpy ``(covs [n-1, 6, 6], manuals [n-1, 6, 6], rel_err
    [n-1])``: the solver's and the closed form's covariance of each new
    pose, and their max relative deviation per step. ``chain_loop``:
    ``run_chain``'s."""
    covs, manuals, _, stats = run_chain(num_poses, device, chain_loop)
    rel_err = np.abs(covs - manuals).max(axis=(1, 2)) / np.abs(manuals).max(axis=(1, 2))
    if verbose:
        print(f"Solver covariance for k={num_poses - 1}:\n{covs[-1]}")
        print(f"Manual covariance for k={num_poses - 1}:\n{manuals[-1]}")
        print(f"max relative deviation over chain: {rel_err.max():.3e}")
        print(f"{stats['steps']} solves, {stats['lm_iterations']} LM iterations in "
              f"{stats['wall_s']:.3f} s = {stats['solves_per_s']:.1f} solves/s (chain loop "
              f"{stats['chain_loop']}, {stats['captures']} captures)")
    return covs, manuals, rel_err


def main(argv=None):
    from ceres_slam_tpu_torch.apps.common import base_parser, resolve_device

    p = base_parser("blowup: covariance propagation experiment")
    p.add_argument("--num-poses", type=int, default=1000)
    p.add_argument("--chain-loop", choices=["device", "host"], default=None,
                   help="the chain as a WHILE node on the card, each step's LM loop nested in "
                        "it (the default there), or on the host (the CPU's form)")
    args = p.parse_args(argv)
    return run(args.num_poses, device=resolve_device(args.device), chain_loop=args.chain_loop)


if __name__ == "__main__":
    main()
