"""Levenberg-Marquardt and dogleg trust-region loops, their configuration and report.

Port of ``ceres_slam_tpu/solver/lm.py`` (``SolveConfig``, ``SolveSummary``,
``lm_solve``, ``dogleg_solve``, ``dense_cholesky_step``). The JAX loop is a
``lax.while_loop`` on the device whose control (accept test, damping,
termination) is a carry of tensors in the cost's dtype; so is this one's:
``Carry`` holds the iterate, the damping, the cost, the last gradient
norm, the iteration count, the done flag, the nonmonotonic buffer, the
best iterate, the initial cost, the CG iterations of a Schur-PCG solve
and, with ``record_history``, the per-iteration cost, damping, gradient
norm and accept flag, written at the iteration's index. ``lm_body`` is one
iteration, a pure function whose branches are ``torch.where``s.
``host_loop`` iterates it on the host, reading the stop test every
iteration (the plain version, the CPU's form, ``loop="host"``);
``device_loop`` captures it once and runs it in a conditional WHILE node
on the card (``ops/graph_loop.DeviceWhile``), one graph launch for the
solve; the step may run a loop of its own inside (Schur-PCG's CG loop, a
nested WHILE node). ``finish`` reads the summary once. ``inner_lm`` runs
a whole LM solve inside a loop of the caller's (``apps/blowup.py``'s chain:
a WHILE node nested in the chain's node on the card). Powell's dogleg
(``dogleg_solve``) follows the same rules: ``DoglegCarry`` (the iterate,
the trust radius, the cost, the gradient norm, the count, the done flag,
the initial cost), ``dogleg_body`` and ``dogleg_loop``, iterated on the
host or run in the same kind of node. The window solver's block-carrying
loops (``solver/window.py``, ``solver/dogleg.py``) apply the same rules to
B windows at once.

On the card these callers run the device loop: Schur-PCG
(``solver/pcg.py``), the dense and Schur solves and the dense dogleg
(``solver/dense.py``, ``solver/schur.py``), the pose graph
(``solver/pose_graph.py``, and ``blowup``'s chain through ``inner_lm``),
Phong (``solver/phong.py``) and photometric alignment
(``solver/photometric.py``), and on NCCL ranks the sharded solves
(``parallel/sharded_ba.py``, ``parallel/sharded_pcg.py``, their
all-reduces captured in the node); gloo ranks run ``host_loop``.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from ceres_slam_tpu_torch.ops import graph_loop
from ceres_slam_tpu_torch.utils import telemetry


class SolveConfig(NamedTuple):
    max_iters: int = 50
    ftol: float = 1e-9
    gtol: float = 1e-12
    # step-size tolerance: stop when max|dx| of an attempted step falls below it
    xtol: float = 1e-14
    init_lambda: float = 1e-4
    min_lambda: float = 1e-12
    max_lambda: float = 1e10
    # Ceres use_nonmonotonic_steps: accept a step that decreases the cost
    # relative to the worst of the last `nonmonotonic_window` accepted costs
    nonmonotonic: bool = False
    nonmonotonic_window: int = 5
    # record the per-iteration cost, lambda (trust radius for dogleg),
    # gradient norm and accept decision in the SolveSummary
    record_history: bool = False
    # benchmarking only: ignore every convergence test and run exactly
    # max_iters iterations, accepted or not, so a measured rate is a pure
    # per-iteration rate
    run_full_budget: bool = False


class SolveSummary(NamedTuple):
    """Per-solve report (Ceres BriefReport equivalent), host scalars read
    from the loop's carry once, after the loop."""

    iterations: int
    initial_cost: float
    final_cost: float
    final_grad_norm: float
    final_lambda: float  # trust radius for dogleg
    linear_iterations: int = 0  # CG iterations over the whole solve (Schur-PCG only)
    # with record_history: [max_iters] arrays, NaN (False) past `iterations`
    cost_history: np.ndarray | None = None
    lambda_history: np.ndarray | None = None
    grad_norm_history: np.ndarray | None = None
    step_accepted: np.ndarray | None = None


# -- the loop's carry ----------------------------------------------------------

class Carry(NamedTuple):
    """The state of the LM loop (JAX's ``_Carry``), every number a 0-d
    tensor in the cost's dtype but the counts: the iterate, the damping,
    the cost, the last gradient norm, the iteration count (int32), the done
    flag, the nonmonotonic buffer of recent accepted costs, the best
    iterate and its cost (kept under nonmonotonic steps), the initial
    cost, the linear solver's iterations summed over the solve (int32), and
    with ``record_history`` the ``[max_iters]`` cost, damping, gradient norm
    and accept flag (NaN, False past the last iteration)."""

    state: object
    lam: torch.Tensor
    cost: torch.Tensor
    grad_norm: torch.Tensor
    it: torch.Tensor  # int32
    done: torch.Tensor  # bool
    cost_buf: torch.Tensor  # [nonmonotonic_window]
    best_state: object
    best_cost: torch.Tensor
    cost0: torch.Tensor
    linear_iterations: torch.Tensor  # int32
    history: tuple  # ([max_iters] x 3, bool [max_iters]) or ()


def leaves(x) -> list:
    """The tensors of a (nested) tuple, in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, tuple):
        return [t for v in x for t in leaves(v)]
    return []


def tree_map(fn, x):
    """``x`` with ``fn`` applied to each tensor (through tuples)."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple):
        vals = [tree_map(fn, v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    return x


def _select(mask: torch.Tensor, new, old):
    """``new`` where ``mask`` (a 0-d bool) is set, else ``old``, tensor by
    tensor through tuples."""
    if isinstance(new, torch.Tensor):
        return torch.where(mask, new, old)
    if isinstance(new, tuple):
        vals = [_select(mask, a, b) for a, b in zip(new, old)]
        return type(new)(*vals) if hasattr(new, "_fields") else tuple(vals)
    return new


def lm_start(state0, config: SolveConfig, cost_fn: Callable) -> Carry:
    """The carry before the first iteration: the cost of ``state0``, the
    initial damping, no iteration."""
    cost0 = cost_fn(state0)
    if not isinstance(cost0, torch.Tensor):
        raise TypeError(f"cost_fn must return a tensor, got {type(cost0).__name__}")
    dt, dev = cost0.dtype, cost0.device
    history = ()
    if config.record_history:
        nan = torch.full((config.max_iters,), math.nan, dtype=dt, device=dev)
        history = (nan, nan.clone(), nan.clone(),
                   torch.zeros(config.max_iters, dtype=torch.bool, device=dev))
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return Carry(state=state0, lam=torch.full((), config.init_lambda, dtype=dt, device=dev),
                 cost=cost0, grad_norm=torch.full((), math.inf, dtype=dt, device=dev), it=zero,
                 done=torch.zeros((), dtype=torch.bool, device=dev),
                 cost_buf=cost0.expand(config.nonmonotonic_window).clone(), best_state=state0,
                 best_cost=cost0, cost0=cost0, linear_iterations=zero.clone(), history=history)


def active(c: Carry, config: SolveConfig) -> torch.Tensor:
    """0-d bool: the loop goes on (JAX's ``cond``)."""
    return ~c.done & (c.it < config.max_iters)


def lm_body(step_fn: Callable, cost_fn: Callable, retract_fn: Callable, config: SolveConfig,
            c: Carry) -> Carry:
    """One LM iteration (``ceres_slam_tpu/solver/lm.py::lm_solve``'s
    ``body``): the damped step, the candidate's cost, the accept test
    against the worst recent accepted cost under nonmonotonic steps, the
    damping rule. A non-finite step (a failed factorization) is a rejected
    step, not convergence; ``ftol`` fires only on a real decrease, so an
    accepted uphill step does not end the solve; ``run_full_budget``
    ignores every stopping test. ``step_fn`` may return the linear
    solver's iterations as a fourth value, summed in the carry. Pure: ``c``
    is left as it was."""
    out = step_fn(c.state, c.lam)
    dx, grad_norm, pred = out[:3]
    dt = c.cost.dtype
    grad_norm, pred = grad_norm.to(dt), pred.to(dt)
    dx_ok = torch.all(torch.isfinite(dx))
    dx = torch.where(dx_ok, dx, torch.zeros_like(dx))
    new_state = retract_fn(c.state, dx)
    new_cost = cost_fn(new_state).to(dt)

    actual = c.cost - new_cost
    rho = actual / torch.clamp(pred, min=1e-30)
    ref = c.cost_buf.amax() if config.nonmonotonic else c.cost
    accept = torch.isfinite(new_cost) & (new_cost < ref)
    lam_down = c.lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
    lam = torch.where(accept, torch.clamp(lam_down, min=config.min_lambda),
                      torch.clamp(c.lam * 4.0, max=config.max_lambda))
    small = accept & (actual >= 0.0) & (actual <= config.ftol * torch.clamp(c.cost, min=1e-30))
    done = (small | (grad_norm <= config.gtol) | (dx_ok & (dx.abs().amax() <= config.xtol))
            | (c.lam >= config.max_lambda))
    if config.run_full_budget:
        done = torch.zeros_like(done)
    cost = torch.where(accept, new_cost, c.cost)
    W = config.nonmonotonic_window
    slot = torch.arange(W, device=dx.device) == torch.remainder(c.it, W)
    best_state, best_cost = c.best_state, c.best_cost
    if config.nonmonotonic:
        better = accept & (new_cost < c.best_cost)
        best_state = _select(better, new_state, c.best_state)
        best_cost = torch.where(better, new_cost, c.best_cost)
    history = c.history
    if config.record_history:
        at = torch.arange(config.max_iters, device=dx.device) == c.it
        history = tuple(torch.where(at, v, h)
                        for h, v in zip(c.history, (cost, lam, grad_norm, accept)))
    linear = c.linear_iterations + out[3] if len(out) > 3 else c.linear_iterations
    return Carry(state=_select(accept, new_state, c.state), lam=lam, cost=cost,
                 grad_norm=grad_norm, it=c.it + 1, done=done,
                 cost_buf=torch.where(accept & slot, new_cost, c.cost_buf),
                 best_state=best_state, best_cost=best_cost, cost0=c.cost0,
                 linear_iterations=linear.to(torch.int32), history=history)


def host_loop(state0, config: SolveConfig, cost_fn: Callable, step_fn: Callable,
              retract_fn: Callable) -> Carry:
    """The plain version of the loop on the card: ``lm_body`` iterated on the
    host, the stop test read every iteration."""
    c = lm_start(state0, config, cost_fn)
    while bool(active(c, config)):
        c = lm_body(step_fn, cost_fn, retract_fn, config, c)
    return c


def _stats(c: Carry, config: SolveConfig) -> torch.Tensor:
    """``[6 (+ 4 max_iters)]`` float64 on the device: iterations, initial
    cost, final cost, gradient norm, damping, linear iterations (and the
    history)."""
    cost = c.best_cost if config.nonmonotonic else c.cost
    f64 = torch.float64
    parts = [torch.stack([x.to(f64) for x in (c.it, c.cost0, cost, c.grad_norm, c.lam,
                                                c.linear_iterations)])]
    return torch.cat(parts + [h.to(f64) for h in c.history])


def summary(stats, config: SolveConfig) -> SolveSummary:
    """The ``SolveSummary`` of ``_stats``' values read on the host."""
    row = np.asarray(stats, dtype=np.float64)
    s = SolveSummary(int(row[0]), *(float(x) for x in row[1:5]), linear_iterations=int(row[5]))
    if config.record_history:
        h = row[6:6 + 4 * config.max_iters].reshape(4, config.max_iters)
        s = s._replace(cost_history=h[0], lambda_history=h[1], grad_norm_history=h[2],
                       step_accepted=h[3] != 0.0)
    return s


def finish(c: Carry, config: SolveConfig):
    """``(state, SolveSummary)`` of a finished loop, the summary read from
    the carry in one copy: under nonmonotonic steps the best accepted
    iterate (Ceres returns the best minimizer)."""
    state = c.best_state if config.nonmonotonic else c.state
    return state, summary(_stats(c, config).cpu(), config)


class LMLoop(NamedTuple):
    """What ``DeviceWhile`` captures: ``body()`` runs one iteration on the
    carry buffers ``carry`` in place and writes the stop test to ``pred``
    (int32, 1: run again). ``restart()`` puts the buffers at the start of a
    new solve, from the initial state's tensors as they are now."""

    carry: Carry
    pred: torch.Tensor  # int32 [1]
    body: object
    restart: object


def _loop(start: Callable, step: Callable, config: SolveConfig) -> LMLoop:
    """Carry buffers made from ``start()`` and a body that writes
    ``step(carry)`` into them in place (any carry with ``it`` and ``done``)."""
    carry = tree_map(torch.clone, start())  # own buffers
    bufs = leaves(carry)
    pred = active(carry, config).reshape(1).to(torch.int32)

    def copy_in(new):
        for buf, t in zip(bufs, leaves(new)):
            if t is not buf:
                buf.copy_(t)
        pred.copy_(active(carry, config).reshape(1))

    return LMLoop(carry, pred, lambda: copy_in(step(carry)), lambda: copy_in(start()))


def lm_loop(state0, config: SolveConfig, cost_fn: Callable, step_fn: Callable,
            retract_fn: Callable) -> LMLoop:
    """The carry buffers and the body of the LM loop, on any device (on the
    CPU the tests iterate ``body`` while ``pred``, as the WHILE node
    does)."""
    return _loop(lambda: lm_start(state0, config, cost_fn),
                 lambda c: lm_body(step_fn, cost_fn, retract_fn, config, c), config)


def inner_lm(lp: LMLoop) -> None:
    """A whole LM solve on ``lp``'s buffers, for the body of a loop of the
    caller's: ``restart()`` (from the initial state's tensors as they are
    now), then ``lp.body`` while ``lp.pred`` through ``graph_loop.
    while_loop``: inside a ``DeviceWhile`` capture a WHILE node nested in
    the caller's node, elsewhere iterated on the host with the stop test
    read every iteration (``host_loop``'s bits). The result stays on the
    device, in ``lp.carry``; the next call overwrites it."""
    lp.restart()
    graph_loop.while_loop(lp.body, lp.pred)


# the loop's form on a device: a WHILE node on the card or the host loop
resolve_loop = graph_loop.resolve_loop


# the captures and restarts of every LMGraph of the process, and their host seconds
GRAPH_STATS = {"captures": 0, "capture_s": 0.0, "build_s": 0.0, "restarts": 0, "restart_s": 0.0}


class LMGraph:
    """LM loops captured once per solve shape and run for every solve of
    that shape: the first solve of a key captures its body on its own
    tensors, which the graph then reads by address; a later solve copies
    its ``inputs`` (every tensor the body reads that changes between
    solves) into those tensors and restarts the loop, with no capture and
    no instantiation. ``close()`` frees every capture; ``GRAPH_STATS``
    counts the captures and restarts."""

    def __init__(self):
        self.loops: dict = {}

    def close(self) -> None:
        for _, _, node in self.loops.values():
            node.close()
        self.loops = {}


def _copy_inputs(dst: tuple, src: tuple) -> None:
    for d, t in zip(dst, src):
        if d.data_ptr() != t.data_ptr():
            d.copy_(t)


def device_loop(state0, config: SolveConfig, cost_fn: Callable, step_fn: Callable,
                retract_fn: Callable, counted=(), graph: LMGraph | None = None,
                inputs: tuple = (), key=None, tallies: dict | None = None):
    """``host_loop`` on the card: ``lm_loop``'s body captured and run in a
    conditional WHILE node, one graph launch for the solve and one read of
    its summary. ``counted``: the kernel wrappers the body launches outside
    its inner loops (an inner loop declares its own, ``graph_loop.
    while_loop``). The first iteration of a new capture runs eagerly, on
    the capture stream, before the capture (it makes the libraries'
    handles and workspaces there); the node runs the rest. With a
    ``graph``, the capture is kept there under ``key`` (the solve's shape
    and every setting the body holds as a Python value) for the next solve,
    which copies its ``inputs`` into this one's; without one it is this
    solve's alone. ``tallies`` maps attribute names of the ``lm.node`` span
    to counted wrappers: the span records each one's launches in the run.
    Returns ``finish``'s ``(state, SolveSummary)`` (new tensors). Raises on
    the CPU, and if the capture fails."""
    return _node_solve(state0, config, lambda: lm_loop(state0, config, cost_fn, step_fn,
                                                       retract_fn),
                       lambda c: (c.best_state if config.nonmonotonic else c.state,
                                  _stats(c, config)),
                       config, counted, graph, inputs, key, tallies)


def _node_solve(state0, config: SolveConfig, make_loop: Callable, readout: Callable,
                report: SolveConfig, counted, graph, inputs, key, tallies=None):
    """``device_loop`` for the loop ``make_loop()`` builds: ``readout(carry)``
    gives the solution and the stats row that ``summary`` reads under
    ``report``."""
    tallies = tallies or {}
    if leaves(state0)[0].device.type != "cuda":
        raise ValueError("the device LM loop runs on the card: use loop='host'")
    own = graph is None
    graph = LMGraph() if own else graph
    key = (config, key, tuple((t.shape, t.dtype) for t in inputs))
    try:
        entry = graph.loops.get(key)
        if entry is None:
            with telemetry.span("lm.capture"):
                lp = make_loop()
                device = lp.pred.get_device()
                stream = graph_loop.capture_stream(device)
                stream.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(stream):
                    if bool(lp.pred):
                        lp.body()  # the first iteration, eagerly
                torch.cuda.current_stream().wait_stream(stream)
                node = graph_loop.DeviceWhile(lp.body, lp.pred, counted=counted)
                graph.loops[key] = entry = (inputs, lp, node)
            GRAPH_STATS["captures"] += 1
            GRAPH_STATS["capture_s"] += node.capture_s
            GRAPH_STATS["build_s"] += node.build_s
        else:
            with telemetry.span("lm.restart") as restart:
                _copy_inputs(entry[0], inputs)
                entry[1].restart()
            GRAPH_STATS["restarts"] += 1
            GRAPH_STATS["restart_s"] += restart.seconds
        _, lp, node = entry
        with telemetry.span("lm.node") as run:
            node.launch()
            state, stats = readout(lp.carry)
            readings = node.readings()
            host = torch.cat([x.to(torch.float64) for x in (stats, *readings)]).cpu()
            before = {name: w.launches for name, w in tallies.items()}
            node.add_counts(host[-sum(r.numel() for r in readings):].tolist())
            run.set(iterations=node.iterations, inner_iterations=node.inner_iterations,
                    device_ns=node.device_ns,
                    **{name: w.launches - before[name] for name, w in tallies.items()})
        with telemetry.span("lm.readout"):
            return tree_map(torch.clone, state), summary(host, report)
    finally:
        if own:
            graph.close()


def lm_solve(state0, config: SolveConfig, cost_fn: Callable, step_fn: Callable,
             retract_fn: Callable, loop: str | None = None, **device_args):
    """Run LM. ``cost_fn(state)`` is the scalar cost (a 0-d tensor, whose
    dtype the control runs in); ``step_fn(state, lam)`` solves the damped
    system (``lam`` a 0-d tensor) and returns the step ``dx``, the max-norm
    of the gradient and the predicted decrease ``-(g.dx + 0.5 dx.H dx)`` of
    the undamped model, and optionally the linear solver's iterations;
    ``retract_fn(state, dx)`` applies the step. Returns ``(state,
    SolveSummary)``; under ``nonmonotonic`` the state is the best accepted
    iterate (Ceres returns the best minimizer).

    ``loop``: ``"host"`` (the default) iterates on the host
    (``host_loop``), ``"device"`` in a WHILE node on the card
    (``device_loop``, which takes ``device_args``; the step, cost and
    retraction must then never read the device from the host). The two
    give the same bits."""
    loop = loop or "host"
    if loop == "device":
        return device_loop(state0, config, cost_fn, step_fn, retract_fn, **device_args)
    if loop != "host":
        raise ValueError(f"unknown LM loop: {loop!r}")
    return finish(host_loop(state0, config, cost_fn, step_fn, retract_fn), config)


def _cholesky_or_nan(A: torch.Tensor) -> torch.Tensor:
    """Batched Cholesky factor; a matrix that is not positive definite gets
    an all-NaN factor (as ``jnp.linalg.cholesky`` gives), so a failed
    factorization becomes a rejected step without a host synchronization."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[..., None, None], L, torch.full_like(L, math.nan))


def cholesky_apply(L: torch.Tensor, b: torch.Tensor, columns: bool = False) -> torch.Tensor:
    """``(L L^T)^{-1} b`` for vectors ``b [..., n]`` (or, with ``columns``,
    matrices ``b [..., n, m]``) and factors ``L [..., n, n]``: two triangular
    solves, as the JAX package applies its factors. Unlike a batched
    ``torch.cholesky_solve`` it never synchronizes with the host on CUDA, so
    a CUDA graph can capture it (``solver/pcg.py``'s CG loop, the window
    loops of ``solver/window.py``, ``dense_cholesky_step``, the Phong
    vertex-Schur step)."""
    y = torch.linalg.solve_triangular(L, b if columns else b[..., None], upper=False)
    x = torch.linalg.solve_triangular(L.mT, y, upper=True)
    return x if columns else x[..., 0]


class DoglegCarry(NamedTuple):
    """The state of the dogleg loop (JAX's ``dogleg_solve`` carry), every
    number a 0-d tensor in the cost's dtype but the count: the iterate, the
    trust radius, the cost, the last gradient norm, the iteration count
    (int32), the done flag and the initial cost."""

    state: object
    radius: torch.Tensor
    cost: torch.Tensor
    grad_norm: torch.Tensor
    it: torch.Tensor  # int32
    done: torch.Tensor  # bool
    cost0: torch.Tensor


def dogleg_start(state0, cost_fn: Callable, init_radius: float) -> DoglegCarry:
    """The dogleg carry before the first iteration."""
    cost0 = cost_fn(state0)
    dt, dev = cost0.dtype, cost0.device
    return DoglegCarry(state=state0, radius=torch.full((), init_radius, dtype=dt, device=dev),
                       cost=cost0, grad_norm=torch.full((), math.inf, dtype=dt, device=dev),
                       it=torch.zeros((), dtype=torch.int32, device=dev),
                       done=torch.zeros((), dtype=torch.bool, device=dev), cost0=cost0)


def dogleg_body(cost_fn: Callable, normal_eq_fn: Callable, retract_fn: Callable,
                config: SolveConfig, c: DoglegCarry) -> DoglegCarry:
    """One dogleg iteration (``ceres_slam_tpu/solver/lm.py::dogleg_solve``'s
    ``body``): the Gauss-Newton step of ``(H + 1e-10 I) dx = -g`` (``-g``
    where it is not finite), the Cauchy step, their blend on the radius,
    the candidate's cost, the radius rule. Pure; the branches are
    ``torch.where``s."""
    H, g = normal_eq_fn(c.state)
    dt, r = c.cost.dtype, c.radius
    grad_norm = g.abs().amax().to(dt)
    eye = torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
    dx_gn = cholesky_apply(_cholesky_or_nan(H + 1e-10 * eye), -g)
    dx_gn = torch.where(torch.all(torch.isfinite(dx_gn)), dx_gn, -g)
    alpha = (g @ g) / torch.clamp(g @ (H @ g), min=1e-30)
    dx_sd = -alpha * g
    n_gn, n_sd = torch.linalg.norm(dx_gn), torch.linalg.norm(dx_sd)
    d = dx_gn - dx_sd
    a, b = d @ d, 2.0 * (dx_sd @ d)
    cc = dx_sd @ dx_sd - r ** 2
    beta = (-b + torch.sqrt(torch.clamp(b * b - 4 * a * cc, min=0.0))) / torch.clamp(
        2 * a, min=1e-30)
    blend = dx_sd + torch.clamp(beta, 0.0, 1.0) * d
    dx = torch.where(n_gn <= r, dx_gn, torch.where(
        n_sd >= r, dx_sd * (r / torch.clamp(n_sd, min=1e-30)), blend))
    new_state = retract_fn(c.state, dx)
    new_cost = cost_fn(new_state).to(dt)
    pred = (-(g @ dx + 0.5 * dx @ (H @ dx))).to(dt)
    actual = c.cost - new_cost
    rho = actual / torch.clamp(pred, min=1e-30)
    accept = torch.isfinite(new_cost) & (actual > 0.0)
    radius = torch.where(rho > 0.75, torch.maximum(r, 3.0 * torch.linalg.norm(dx).to(dt)),
                         torch.where(rho < 0.25, r * 0.5, r))
    radius = torch.clamp(torch.where(accept, radius, r * 0.25), 1e-12, 1e12)
    small = accept & (actual >= 0.0) & (actual <= config.ftol * torch.clamp(c.cost, min=1e-30))
    done = small | (grad_norm <= config.gtol) | (radius <= 1e-11)
    return DoglegCarry(state=_select(accept, new_state, c.state), radius=radius,
                       cost=torch.where(accept, new_cost, c.cost), grad_norm=grad_norm,
                       it=c.it + 1, done=done, cost0=c.cost0)


def dogleg_loop(state0, config: SolveConfig, cost_fn: Callable, normal_eq_fn: Callable,
                retract_fn: Callable, init_radius: float = 1e4) -> LMLoop:
    """The carry buffers and the body of the dogleg loop (``lm_loop``'s
    form: ``body``, ``restart``, ``pred``)."""
    return _loop(lambda: dogleg_start(state0, cost_fn, init_radius),
                 lambda c: dogleg_body(cost_fn, normal_eq_fn, retract_fn, config, c), config)


def _dogleg_stats(c: DoglegCarry) -> torch.Tensor:
    """``_stats``' first six entries for a dogleg carry (the radius in the
    damping's place, no linear iterations)."""
    f64 = torch.float64
    return torch.stack([x.to(f64) for x in (c.it, c.cost0, c.cost, c.grad_norm, c.radius,
                                            torch.zeros_like(c.it))])


def dogleg_solve(state0, config: SolveConfig, cost_fn: Callable, normal_eq_fn: Callable,
                 retract_fn: Callable, init_radius: float = 1e4, loop: str | None = None,
                 graph: LMGraph | None = None, inputs: tuple = (), key=None):
    """Powell's dogleg trust-region minimizer over a dense system (Ceres'
    DOGLEG): the Gauss-Newton step of ``(H + 1e-10 I) dx = -g`` (``-g``
    where that step is not finite), the Cauchy step ``-(g.g / g.H g) g``,
    and their blend on the trust radius, which grows past rho 0.75 and
    shrinks below 0.25 or on a rejected step, clipped to [1e-12, 1e12].
    ``normal_eq_fn(state)`` returns the dense ``(H, g)``. Returns ``(state,
    SolveSummary)`` with the final radius in ``final_lambda``.

    ``loop``: ``"host"`` (the default) iterates ``dogleg_body`` on the host,
    ``"device"`` runs it in a WHILE node on the card (``device_loop``'s
    ``graph``, ``inputs`` and ``key``); the two give the same bits."""
    loop = loop or "host"
    report = config._replace(record_history=False)
    if loop == "device":
        return _node_solve(state0, config, lambda: dogleg_loop(
            state0, config, cost_fn, normal_eq_fn, retract_fn, init_radius),
            lambda c: (c.state, _dogleg_stats(c)), report, (), graph, inputs,
            ("dogleg", init_radius, key))
    if loop != "host":
        raise ValueError(f"unknown LM loop: {loop!r}")
    c = dogleg_start(state0, cost_fn, init_radius)
    while bool(active(c, config)):
        c = dogleg_body(cost_fn, normal_eq_fn, retract_fn, config, c)
    return c.state, summary(_dogleg_stats(c).cpu(), report)


def dense_cholesky_step(normal_eq_fn: Callable):
    """Standard damped dense step: ``(H + lam diag(H)) dx = -g``, the factor
    applied by two triangular solves (JAX's ``cho_solve``; ``cholesky_apply``),
    so a captured loop can run it."""

    def step(state, lam):
        H, g = normal_eq_fn(state)
        diag = torch.clamp(torch.diagonal(H), 1e-12, 1e32)
        L = _cholesky_or_nan(H + lam * torch.diag(diag))
        dx = cholesky_apply(L, -g)
        pred = -(g @ dx + 0.5 * dx @ (H @ dx))
        return dx, g.abs().max(), pred

    return step
