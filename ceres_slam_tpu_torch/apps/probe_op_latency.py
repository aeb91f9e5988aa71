"""The subspace_step kernel's latency bound, from latencies this card measures.

``csrc/subspace_step.cu`` is bound by one window's chain of dependent
operations, not by its 72 bytes. ``CHAIN`` counts that chain by kind from
the source, in terms of the kernel's round structure
(``subspace_kernel.BISECTIONS`` steps in ``ROUNDS`` rounds of ``LEVELS``
levels, the source's ``kBisections`` and ``kLevels``). ``op_latencies``
measures each kind's latency on the card with ``csrc/op_chain.cu``: one
warp's chain of n dependent operations of a kind, timed between CUDA
events less a chain of 0, over n. ``latency_bound_us`` is the chain at
those latencies: the least time a window takes, the loads, the store and
the launch left out. Needs a card:

  python -m ceres_slam_tpu_torch.apps.probe_op_latency
"""

from __future__ import annotations

import ctypes
import statistics

import torch

from ceres_slam_tpu_torch.ops import cuda_build
from ceres_slam_tpu_torch.ops import subspace_kernel as sk

_SOURCES = ("op_chain.cu",)
_fns: dict = {}

# One window's chain of dependent operations in csrc/subspace_step.cu, by
# kind (compares, selects and clamps left out): the eigenbasis and bracket
# (8 adds, 5 muls, 2 divisions, 3 square roots); each round's LEVELS - 1
# path steps (add, mul), the node's mid (add, mul), its test (add,
# division, mul, add) and the exchange (the ballot, the walk, the shuffle);
# the fill, the projection, the first candidate's model value and the
# predicted decrease (13 adds, 11 muls, 2 divisions, 2 square roots).
CHAIN = {"add": 8 + sk.ROUNDS * (sk.LEVELS + 2) + 13,
         "mul": 5 + sk.ROUNDS * (sk.LEVELS + 1) + 11,
         "div": 2 + sk.ROUNDS + 2, "sqrt": 3 + 2, "exchange": sk.ROUNDS}
_PROBED = ("add", "mul", "div", "sqrt", "exchange")  # the source's kinds 0-4


def build() -> str:
    """Compile (at first use) and load the probe; returns the library path."""
    p, i = ctypes.c_void_p, ctypes.c_int
    sig = [p, p, i, i, i, i, i, p]  # seed, out, kind, n, levels, device, multi_device, stream
    lib = cuda_build.load("op_chain", _SOURCES, {"op_chain_f32": sig, "op_chain_f64": sig})
    _fns.update({torch.float32: lib.op_chain_f32, torch.float64: lib.op_chain_f64})
    return str(cuda_build.library_path("op_chain", _SOURCES))


def op_latencies(dtype=torch.float64, device="cuda", n: int = 1 << 14, reps: int = 5) -> dict:
    """The card's latency of each operation kind of ``CHAIN`` in ns (one
    warp's chain of ``n`` dependent operations of a kind, timed between
    CUDA events less a chain of 0, over ``n``; medians of ``reps``). A
    round's exchange is probed with an add after it, whose latency is taken
    off."""
    if not _fns:
        build()
    seed = torch.tensor([1.0, 1.0 + 2.0 ** -20], dtype=dtype, device=device)
    out = torch.empty(32, dtype=dtype, device=device)
    dev = seed.get_device()
    fn, multi = _fns[dtype], torch.cuda.device_count() > 1

    def ms(kind, length):
        times = []
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            err = fn(seed.data_ptr(), out.data_ptr(), kind, length, sk.LEVELS, dev, multi,
                     cuda_build.current_stream(dev))
            end.record()
            if err:
                raise cuda_build.launch_error(err, "op_chain")
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    lat = {name: (ms(kind, n) - ms(kind, 0)) / n * 1e6 for kind, name in enumerate(_PROBED)}
    lat["exchange"] -= lat["add"]
    return lat


def latency_bound_us(lat: dict) -> float:
    """The least time one window's ``CHAIN`` takes at the latencies ``lat``
    (``op_latencies``, ns), in us."""
    return sum(n * lat[k] for k, n in CHAIN.items()) / 1e3


def main() -> None:
    for tag, dtype in (("f64", torch.float64), ("f32", torch.float32)):
        lat = op_latencies(dtype)
        print(f"{tag}: " + ", ".join(f"{k} {lat[k]:.3f} ns" for k in CHAIN)
              + f"; a window's chain {CHAIN}: latency bound {latency_bound_us(lat):.3f} us")


if __name__ == "__main__":
    main()
