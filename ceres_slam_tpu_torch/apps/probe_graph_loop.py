"""Can a kernel launch be captured in a CUDA graph and replayed?

The port's counterpart of ``scripts/probe_pallas_scan.py``, which asks the
TPU toolchain whether a Pallas kernel (``double_kernel``, o = 2 x) can run
inside ``lax.scan`` and ``lax.while_loop``. On Hopper the question is
whether a launch on the port's thin launch path can be captured in a CUDA
graph (``torch.cuda.CUDAGraph``) and replayed, and run in a loop on the
device (``ops/graph_loop.DeviceWhile``: a conditional WHILE node), which a
launch-light solver loop needs. The cases, each in its own process (a
failed capture must not take down the matrix):

  grid_in_graph        3 launches of P's 4-block form captured in one graph, replayed
  grid1_in_graph       the same with P's 1-block form
  eager_loop           3 launches in a Python loop, no graph
  grid_in_replay_loop  one captured in-place launch, replayed 3 times from the
                       host (the loop and its count stay on the host)
  grid_in_while        the TPU probe's grid_in_while: P's in-place 4-block
                       launch as the body of a WHILE node, with a counter on
                       the device that stops the loop at 3
  grid_in_while_data   the same body while sum(x) < 8 sum(x0), a condition
                       on the data the body wrote (the form CG's loop takes)
  k1_in_graph          3 launches of K1 (window_factor_blocks) on a flagship
                       window plan captured in one graph: each replay must equal
                       the eager launches bit for bit, also after the poses
                       are changed in place between replays

Each P case must give ``x * 8`` bit for bit for ``x = arange(1024)`` as a
``[2, 512]`` float32 array (sum 4190208.0). Prints ``<case> OK <sum>`` or
``<case> FAILED: <reason>`` per case:

  python -m ceres_slam_tpu_torch.apps.probe_graph_loop [case]
"""

from __future__ import annotations

import os
import subprocess
import sys

P_CASES = ("grid_in_graph", "grid1_in_graph", "eager_loop", "grid_in_replay_loop",
           "grid_in_while", "grid_in_while_data")
CASES = P_CASES + ("k1_in_graph",)
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _check_times8(torch, x, y):
    if not torch.equal(y, x * 8):
        raise AssertionError(f"result differs from x * 8 at {int((y != x * 8).sum())} elements")
    return float(y.sum())


def p_while(torch, x, stop: int = 3, data: bool = False):
    """P's while form on the card: returns ``(loop, buf, reset)``, a
    ``DeviceWhile`` whose body doubles ``buf`` in place (P's 4-block
    launch) while a counter on the device is below ``stop`` or, with
    ``data``, while ``sum(buf) < 2**stop * sum(x)``; ``reset()`` puts
    ``buf`` back to ``x`` and the condition to its start. Both forms run
    ``stop`` iterations from ``x = arange(1024)``."""
    from ceres_slam_tpu_torch.ops import double_kernel as P
    from ceres_slam_tpu_torch.ops import graph_loop

    threshold = float(x.sum()) * 2 ** stop
    buf = x.clone()
    i = torch.zeros(1, dtype=torch.int32, device=x.device)
    pred = torch.ones(1, dtype=torch.int32, device=x.device)

    def body():
        P.double_kernel(buf, out=buf)
        if data:
            pred.copy_(buf.sum() < threshold)
        else:
            i.add_(1)
            pred.copy_(i < stop)

    P.double_kernel(x)  # build and load outside the capture
    loop = graph_loop.DeviceWhile(body, pred, counted=(P.double_kernel,))

    def reset():
        buf.copy_(x)
        i.zero_()
        if data:
            pred.copy_(x.sum() < threshold)
        else:
            pred.fill_(int(stop > 0))

    return loop, buf, reset


def p_case(torch, case: str) -> float:
    """Run one of P's cases on the current card; returns the result's sum
    (raises unless it is x * 8 bit for bit)."""
    from ceres_slam_tpu_torch.ops import double_kernel as P

    x = torch.arange(1024, dtype=torch.float32, device="cuda").reshape(2, 512)
    one_block = case == "grid1_in_graph"
    if case == "eager_loop":
        y = x
        for _ in range(3):
            y = P.double_kernel(y)
        torch.cuda.synchronize()
        return _check_times8(torch, x, y)
    if case in ("grid_in_while", "grid_in_while_data"):
        loop, buf, reset = p_while(torch, x, data=case == "grid_in_while_data")
        reset()
        n = loop.run()
        plain, m = x, 0  # the same loop on the host, with P's plain version
        while (float(plain.sum()) < float(x.sum()) * 8) if case.endswith("data") else m < 3:
            plain, m = P.double_kernel_plain(plain), m + 1
        loop.close()
        if n != m or not torch.equal(buf, plain):
            raise AssertionError(f"{n} iterations on the device, {m} on the host, results "
                                 f"{'equal' if torch.equal(buf, plain) else 'different'}")
        return _check_times8(torch, x, buf)
    P.double_kernel(x, one_block=one_block)  # build and load outside the capture
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    if case == "grid_in_replay_loop":
        buf = x.clone()
        with torch.cuda.graph(g):
            P.double_kernel(buf, out=buf)
        for _ in range(3):
            g.replay()
        torch.cuda.synchronize()
        return _check_times8(torch, x, buf)
    with torch.cuda.graph(g):
        y = x
        for _ in range(3):
            y = P.double_kernel(y, one_block=one_block)
    g.replay()
    torch.cuda.synchronize()
    return _check_times8(torch, x, y)


def _k1_case(torch) -> float:
    """K1 on the flagship window shape (K=2, J=192, O=2, float64)."""
    from ceres_slam_tpu_torch.ops import lie, window_kernel

    plan, poses, points = window_kernel.random_inputs(2, 192, 2, torch.float64, "cuda", seed=7)
    n = 3
    eager = [window_kernel.window_factor_blocks(plan, poses, points) for _ in range(n)]
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        captured = [window_kernel.window_factor_blocks(plan, poses, points) for _ in range(n)]
    total = 0.0
    for step in range(2):
        if step:  # move the poses in place: the graph reads them by address
            xi = torch.full((2, 6), 1e-3, dtype=poses.dtype, device=poses.device)
            poses.copy_(lie.se3_retract(poses, xi))
            eager = [window_kernel.window_factor_blocks(plan, poses, points) for _ in range(n)]
        g.replay()
        torch.cuda.synchronize()
        for e, c in zip(eager, captured):
            if not all(torch.equal(a, b) for a, b in zip(e, c)):
                raise AssertionError(f"replay {step} differs from the eager launches")
        total += float(captured[-1][4])
    return total


def run_case(case: str) -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available")
    total = _k1_case(torch) if case == "k1_in_graph" else p_case(torch, case)
    print(case, "OK", total, flush=True)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv:
        if argv[0] not in CASES:
            raise SystemExit(f"unknown case {argv[0]!r}; cases: {', '.join(CASES)}")
        run_case(argv[0])
        return {}
    results = {}
    env = {**os.environ, "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    for case in CASES:
        r = subprocess.run([sys.executable, "-m", "ceres_slam_tpu_torch.apps.probe_graph_loop",
                            case], capture_output=True, text=True, timeout=600, cwd=ROOT, env=env)
        lines = r.stdout.strip().splitlines()
        if r.returncode == 0 and lines:
            line = lines[-1]
        else:
            err = [ln for ln in r.stderr.strip().splitlines() if ln.strip()][-1:]
            line = f"{case} FAILED: {err[0][:200] if err else f'exit {r.returncode}'}"
        results[case] = line
        print(line, flush=True)
    return results


if __name__ == "__main__":
    main()
