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
  linalg_in_graph      the linear algebra of a live-VO frame under a capture:
                       ``torch.linalg.svd`` and ``det`` of RANSAC's [400, 3, 3]
                       cross-covariances and ``solve_ex`` of the pose
                       refinement's 6x6 system, float64, each captured alone:
                       prints which capture and which refuse (and why); the
                       captured ones must replay the eager bits
  psum_in_while        the sharded solves' collective under a capture: on
                       ``--world N`` NCCL ranks (child processes, one a card),
                       ``sharded_ba.psum`` (on ranks of one host the peer
                       all-reduce kernel, ``ops/allreduce_kernel``) of a small
                       buffer eagerly, in a plain CUDA graph replayed 3 times,
                       in a 5-iteration ``DeviceWhile`` and as a 5-iteration
                       ``while_loop`` nested in a 2-iteration ``DeviceWhile``
                       body: the sums and the iteration counts must be the
                       eager loop's; each rank prints the kernels one eager
                       call runs (profiled) and the node types of every
                       captured segment, and its stages as it goes; a group
                       that outlives 120 s is killed
  nccl_in_while        the same stages with NCCL's own all-reduce
                       (``dist.all_reduce``) in place of ``psum``, a
                       diagnostic: the kernels one eager all-reduce runs
                       (compare --world 1 and N), each segment's node types,
                       and each
                       stage's outcome (passed, refused by the WHILE node's
                       node-type check, wrong sums, or killed after 90 s
                       where it hangs) under each setting of
                       ``NCCL_VARIANTS`` (``--variant NAME`` runs one; by
                       default all, one group each); exits 0 when every
                       variant reported

Each P case must give ``x * 8`` bit for bit for ``x = arange(1024)`` as a
``[2, 512]`` float32 array (sum 4190208.0). Prints ``<case> OK <sum>`` or
``<case> FAILED: <reason>`` per case:

  python -m ceres_slam_tpu_torch.apps.probe_graph_loop [case] [--world N] [--variant NAME]
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

P_CASES = ("grid_in_graph", "grid1_in_graph", "eager_loop", "grid_in_replay_loop",
           "grid_in_while", "grid_in_while_data")
DIST_CASES = ("psum_in_while", "nccl_in_while")
# nccl_in_while's settings, one group each: NCCL's environment, or the
# captures' capture_error_mode (graph_loop.CAPTURE_ERROR_MODE)
NCCL_VARIANTS = {"default": {}, "graph_register_0": {"NCCL_GRAPH_REGISTER": "0"},
                 "nvls_0": {"NCCL_NVLS_ENABLE": "0"},
                 "graph_mixing_0": {"NCCL_GRAPH_MIXING_SUPPORT": "0"},
                 "thread_local": {}}
CASES = P_CASES + ("k1_in_graph", "linalg_in_graph") + DIST_CASES
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


def _linalg_case(torch) -> float:
    """Each live-VO linear-algebra call captured alone in a graph; the
    result line lists each call's outcome."""
    g = torch.Generator().manual_seed(0)
    W = torch.randn(400, 3, 3, generator=g, dtype=torch.float64).cuda()
    A = torch.randn(6, 6, generator=g, dtype=torch.float64)
    H = (A @ A.T + torch.eye(6, dtype=torch.float64)).cuda()
    b = torch.randn(6, generator=g, dtype=torch.float64).cuda()
    calls = {"svd": lambda: torch.linalg.svd(W),
             "det": lambda: (torch.linalg.det(W),),
             "solve_ex": lambda: torch.linalg.solve_ex(H, b),
             "cholesky_ex": lambda: torch.linalg.cholesky_ex(H)}
    outcome, total = {}, 0.0
    for name, fn in calls.items():
        eager = fn()
        torch.cuda.synchronize()
        stream = torch.cuda.Stream()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, stream=stream):
                out = fn()
            graph.replay()
            torch.cuda.synchronize()
            same = all(torch.equal(a, c) for a, c in zip(eager, out))
            outcome[name] = "captured, replay " + ("bit-equal" if same else "DIFFERS")
            total += float(out[0].double().sum())
        except Exception as e:  # noqa: BLE001 - the outcome is the probe's result
            outcome[name] = f"refused: {type(e).__name__}: {str(e).splitlines()[0][:160]}"
            torch.cuda.synchronize()
    print("linalg_in_graph: " + "; ".join(f"{k} {v}" for k, v in outcome.items()), flush=True)
    return total


def _device_ops(torch, fn) -> list:
    """The names of the device kernels and copies one call of ``fn`` runs
    (after a warm-up call), from torch.profiler, shortened."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    def short(name):
        name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
        return name.split("(")[0][:80]

    return sorted({short(e.name) for e in prof.events() if e.device_type == DeviceType.CUDA})


def _dist_case(torch, case: str, variant: str) -> float:
    """One rank of ``psum_in_while`` or ``nccl_in_while`` (the group joined
    through the ``CERES_*`` environment), stage by stage, each stage's progress printed as it
    happens (a stage that hangs shows where): the loop eagerly, one
    reduction in a plain CUDA graph replayed 3 times, the flat loop in a
    ``DeviceWhile``, and the loop nested in a second one, each checked
    against its eager sums and counts, with the node types of every captured
    segment. ``psum_in_while`` raises at the first stage that fails;
    ``nccl_in_while`` reports each stage and goes on."""
    import torch.distributed as dist

    from ceres_slam_tpu_torch.ops import graph_loop
    from ceres_slam_tpu_torch.parallel import multihost, sharded_ba

    os.environ.update(NCCL_VARIANTS[variant])
    if variant == "thread_local":
        graph_loop.CAPTURE_ERROR_MODE = "thread_local"
    if not multihost.initialize(device="cuda", timeout_s=120):
        raise SystemExit(f"{case} needs CERES_COORDINATOR_ADDRESS, CERES_NUM_PROCESSES and "
                         f"CERES_PROCESS_ID")
    diagnostic = case == "nccl_in_while"
    try:
        rank, world = dist.get_rank(), dist.get_world_size()

        def say(msg):
            print(f"rank {rank} of {world}: {msg}", flush=True)

        mesh = sharded_ba.make_mesh()
        group = mesh.get_group(0)
        if diagnostic:
            counted = ()

            def reduce(t):
                dist.all_reduce(t, group=group)
                return t
        else:
            counted = sharded_ba.COUNTED

            def reduce(t):
                return sharded_ba.psum(mesh, t)[0]
        say(f"torch {torch.__version__}, NCCL {torch.cuda.nccl.version()}, variant {variant} "
            f"{NCCL_VARIANTS[variant]}, capture_error_mode {graph_loop.CAPTURE_ERROR_MODE}, "
            f"peer route {sharded_ba.peer_route(group)}, card {torch.cuda.current_device()}")
        x = torch.arange(8, dtype=torch.float64, device="cuda") + rank
        acc = torch.zeros_like(x)
        i, j = (torch.zeros(1, dtype=torch.int32, device="cuda") for _ in range(2))
        pred_in, pred = (torch.ones(1, dtype=torch.int32, device="cuda") for _ in range(2))
        # x + r summed over the ranks
        base = world * torch.arange(8, dtype=torch.float64) + world * (world - 1) / 2
        say(f"one eager {'all_reduce' if diagnostic else 'psum'} runs on the device: "
            + ", ".join(_device_ops(torch, lambda: reduce(x.clone()))))

        def inner():
            acc.add_(reduce(x * (1 + i)))
            i.add_(1)
            pred_in.copy_(i < 5)

        def outer():
            i.zero_()
            pred_in.fill_(1)
            graph_loop.while_loop(inner, pred_in, counted=counted)
            j.add_(1)
            pred.copy_(j < 2)

        outcome = {}

        def stage(name, run, want):
            say(f"{name}: starting")
            try:
                counts = run()
                got = acc.cpu()
                if not torch.equal(got, want):
                    raise AssertionError(f"sums {got.tolist()} (want {want.tolist()})")
            except (RuntimeError, AssertionError) as e:
                if not diagnostic:
                    raise
                outcome[name] = f"FAILED: {type(e).__name__}: {str(e).splitlines()[0][:300]}"
                say(f"{name} {outcome[name]}")
                torch.cuda.synchronize()
                return
            outcome[name] = "OK"
            say(f"{name} OK{counts}")

        def eager():
            outer()
            torch.cuda.synchronize()
            return ""

        def plain():
            acc.zero_()
            i.zero_()
            g = graph_loop.DeviceGraph(inner, x.get_device(), counted=counted)
            say(f"plain graph: captured, nodes {graph_loop.node_types(g.graph)}; replaying")
            for _ in range(3):
                g.replay()
            torch.cuda.synchronize()
            g.close()
            return ""

        def node(body, p, name):
            acc.zero_()
            i.zero_()
            j.zero_()
            pred_in.fill_(1)
            pred.fill_(1)
            c0 = sharded_ba.psum.collectives
            loop = graph_loop.DeviceWhile(body, p, counted=counted)
            say(f"{name}: captured, segments' nodes "
                f"{[graph_loop.node_types(g) for g, _, _ in loop.segments]}; launching")
            n = loop.run()
            loop.close()
            return (f", {n} x {loop.inner_iterations} iterations, psum counted "
                    f"{sharded_ba.psum.collectives - c0} collectives")

        stage("eager", eager, 15 * base)
        stage("plain graph (3 replays)", plain, 6 * base)  # i = 0, 1, 2 in turn
        stage("flat node", lambda: node(inner, pred_in, "flat node"), 15 * base)
        stage("nested node", lambda: node(outer, pred, "nested node"), 30 * base)
        say(f"{case} {variant}: " + "; ".join(f"{k} {v}" for k, v in outcome.items()))
        return float(acc.sum())
    finally:
        multihost.shutdown()


def _run_ranks(case: str, world: int, timeout: float = 120.0, args: tuple = ()) -> None:
    """``world`` ranks of ``case`` (with ``args``) as child processes on a
    free local port, each rank's output in a file under the system's
    temporary directory; prints every rank's output, and raises unless each
    exits with 0 within ``timeout`` seconds (a rank that hangs is killed)."""
    import socket
    import tempfile

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "CERES_COORDINATOR_ADDRESS": f"127.0.0.1:{port}", "CERES_NUM_PROCESSES": str(world)}
    logs = [tempfile.TemporaryFile("w+") for _ in range(world)]
    procs = [subprocess.Popen([sys.executable, "-m", "ceres_slam_tpu_torch.apps.probe_graph_loop",
                               case, *args], env={**env, "CERES_PROCESS_ID": str(r)}, cwd=ROOT,
                              stdout=log, stderr=subprocess.STDOUT)
             for r, log in enumerate(logs)]
    t0 = time.monotonic()
    hung = False
    for p in procs:
        try:
            p.wait(timeout=max(1.0, t0 + timeout - time.monotonic()))
        except subprocess.TimeoutExpired:
            hung = True
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    failed = []
    for r, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        print(f"--- rank {r} (exit {p.returncode}) ---\n{log.read().strip()[-6000:]}", flush=True)
        log.close()
        if p.returncode:
            failed.append(r)
    what = " ".join((case, *args))
    if hung or failed:
        raise SystemExit(f"{what} FAILED on rank(s) {failed}"
                         f"{f' (killed after {timeout:g} s)' if hung else ''}")
    print(f"{what} OK on {world} rank(s)", flush=True)


def _nccl_variants(world: int, variants) -> dict:
    """``nccl_in_while`` on ``world`` ranks under each of ``variants``, one
    group each (90 s); returns each variant's outcome: the ranks' last
    summary line, or the group's failure."""
    outcome = {}
    for v in variants:
        try:
            _run_ranks("nccl_in_while", world, 90.0, ("--variant", v))
            outcome[v] = "reported"
        except SystemExit as e:
            outcome[v] = str(e)
    for v, o in outcome.items():
        print(f"nccl_in_while --world {world} --variant {v}: {o}", flush=True)
    return outcome


def run_case(case: str, variant: str = "default") -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available")
    if case in DIST_CASES:
        total = _dist_case(torch, case, variant)
    elif case == "linalg_in_graph":
        total = _linalg_case(torch)
    else:
        total = _k1_case(torch) if case == "k1_in_graph" else p_case(torch, case)
    print(case, "OK", total, flush=True)


def _option(argv, name: str, default=None):
    return argv[argv.index(name) + 1] if name in argv else default


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv:
        case = argv[0]
        if case not in CASES:
            raise SystemExit(f"unknown case {case!r}; cases: {', '.join(CASES)}")
        variant = _option(argv, "--variant")
        if variant is not None and (case != "nccl_in_while" or variant not in NCCL_VARIANTS):
            raise SystemExit(f"--variant takes nccl_in_while and one of {', '.join(NCCL_VARIANTS)}")
        if case in DIST_CASES and "CERES_PROCESS_ID" not in os.environ:
            world = int(_option(argv, "--world", 1))
            if case == "nccl_in_while":
                _nccl_variants(world, [variant] if variant else list(NCCL_VARIANTS))
            else:
                _run_ranks(case, world)
        else:
            run_case(case, variant or "default")
        return {}
    results = {}
    env = {**os.environ, "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    for case in CASES:
        if case in DIST_CASES:
            continue  # each run on its own: ``<case> --world N``
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
