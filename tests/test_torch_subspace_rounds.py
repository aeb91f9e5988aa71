"""The round structure of the subspace_step kernel's bisection
(``csrc/subspace_step.cu``: one warp a window, the 64 steps as 13 rounds of
a 31-node tree), replayed on the CPU with torch, against the plain
version's 64 sequential steps (``ops/subspace_kernel.bisect``) bit for bit.

The replay does what the warp does: in each round, node l < 31 of the tree
of the next 5 steps (4 in the last round) computes its interval by
repeating the sequential step's updates along its path from the root (4
predicated steps, as the kernel's lanes run them), its mid and the test
``too_big(mid)``; the 31 answers become a ballot mask; the walk from the
root by the mask's bits reaches the last level's node, whose interval and
mid give the round's (lo, hi). The inputs are the ones the plain version
hands its bisection on ``subspace_kernel.random_models``: interior,
boundary, indefinite and hard cases, the 1-D collapse, a zero gradient, a
model that is not finite, and random models with radii over 8 decades.
Exact equality: the same operations on the same values (NaN where NaN).
"""

import re
from pathlib import Path

import pytest
import torch

from ceres_slam_tpu_torch.apps import probe_op_latency
from ceres_slam_tpu_torch.ops import subspace_kernel as sk

LANES, LEVELS = 32, sk.LEVELS
SOURCE = Path(sk.__file__).resolve().parent.parent / "csrc" / "subspace_step.cu"


def _rounds():
    """The levels of each round: 12 of 5, then 4 (64 steps)."""
    out, done = [], 0
    while done < sk.BISECTIONS:
        out.append(min(LEVELS, sk.BISECTIONS - done))
        done += out[-1]
    return out


def replay(lo, hi, e1, e2, ngh1, ngh2, rr):
    """The kernel's bisection on tensors of windows ``[B]``: a lane is a
    column of ``[B, 32]``."""
    path = torch.arange(1, LANES + 1)  # heap node l, plus one
    depth = torch.floor(torch.log2(path.double())).long()
    cols = [x[:, None] for x in (e1, e2, ngh1, ngh2, rr)]
    for levels in _rounds():
        a = lo[:, None].expand(-1, LANES).clone()
        b = hi[:, None].expand(-1, LANES).clone()
        for j in range(LEVELS - 2, -1, -1):
            mid = 0.5 * (a + b)
            step = j < depth
            right = ((path >> j) & 1).bool()
            a = torch.where(step & right, mid, a)
            b = torch.where(step & ~right, mid, b)
        mid = 0.5 * (a + b)
        big = sk.too_big(mid, *cols)
        bits = (big.long() << torch.arange(LANES)).sum(1)  # __ballot_sync
        node = torch.zeros_like(bits)
        for _ in range(levels - 1):
            node = 2 * node + 1 + ((bits >> node) & 1)
        up = ((bits >> node) & 1).bool()
        take = node[:, None]
        na, nb, nm = (t.gather(1, take)[:, 0] for t in (a, b, mid))  # __shfl_sync
        lo, hi = torch.where(up, nm, na), torch.where(up, nb, nm)
    return lo, hi


def _bisections(model, radius, monkeypatch):
    """The arguments and the result of every bisection the plain version
    runs on ``(model, radius)``, and its output."""
    calls, plain = [], sk.bisect

    def record(*args):
        out = plain(*args)
        calls.append((args, out))
        return out

    monkeypatch.setattr(sk, "bisect", record)
    y = sk.subspace_step_plain(model, radius)
    monkeypatch.setattr(sk, "bisect", plain)
    return calls, y


def _same(x, y):
    return torch.equal(torch.isnan(x), torch.isnan(y)) and torch.equal(
        torch.nan_to_num(x), torch.nan_to_num(y))


def test_constants_are_the_sources():
    """The Python side's steps and levels a round are the kernel's own
    (``kBisections``, ``kLevels``), and the latency bound's chain counts
    the kernel's rounds: one exchange and one division a round, LEVELS + 2
    adds and LEVELS + 1 muls a round (LEVELS - 1 path steps, the mid, the
    test)."""
    text = SOURCE.read_text()
    found = {k: int(re.search(rf"constexpr int {k} = (\d+);", text).group(1))
             for k in ("kBisections", "kLevels")}
    assert found == {"kBisections": sk.BISECTIONS, "kLevels": sk.LEVELS}
    chain = probe_op_latency.CHAIN
    assert chain["exchange"] == sk.ROUNDS == len(_rounds())
    assert chain["div"] - 4 == sk.ROUNDS
    assert chain["add"] - 21 == sk.ROUNDS * (sk.LEVELS + 2)
    assert chain["mul"] - 16 == sk.ROUNDS * (sk.LEVELS + 1)


def test_round_structure():
    """13 rounds, 12 of 5 levels and one of 4, cover the 64 steps; a
    round's tree has 31 nodes, one a lane, and the walk ends on a node of
    the last level."""
    assert _rounds() == [5] * 12 + [4] and len(_rounds()) == sk.ROUNDS == 13
    assert sum(_rounds()) == sk.BISECTIONS == 64
    assert 2 ** LEVELS - 1 == LANES - 1
    for levels in (5, 4):
        ends = set()
        for bits in range(1 << (2 ** levels - 1)) if levels < 5 else range(0, 1 << 31, 65537):
            node = 0
            for _ in range(levels - 1):
                node = 2 * node + 1 + ((bits >> node) & 1)
            ends.add(node)
        assert ends <= set(range(2 ** (levels - 1) - 1, 2 ** levels - 1))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("B", [1, 7, 200])
def test_rounds_equal_sequential_bisection(B, dtype, monkeypatch):
    """On ``random_models(B)`` (its first seven windows the fixed cases),
    the replayed rounds give the plain bisection's (lo, hi) bit for bit,
    and the plain version with the rounds in place of its loop gives the
    same output."""
    model, radius = sk.random_models(B, dtype, seed=B)
    calls, y = _bisections(model, radius, monkeypatch)
    assert len(calls) == 1
    args, (lo, hi) = calls[0]
    got_lo, got_hi = replay(*args)
    assert got_lo.dtype == dtype and _same(got_lo, lo) and _same(got_hi, hi)
    monkeypatch.setattr(sk, "bisect", replay)
    assert _same(sk.subspace_step_plain(model, radius), y)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("case", range(7), ids=["interior", "boundary", "indefinite", "hard",
                                                "collapse_1d", "zero_gradient", "not_finite"])
def test_rounds_on_each_case_alone(case, dtype, monkeypatch):
    """Each fixed case of ``random_models`` as a batch of one."""
    model, radius = sk.random_models(7, dtype, seed=0)
    model, radius = model[case:case + 1].contiguous(), radius[case:case + 1].contiguous()
    calls, y = _bisections(model, radius, monkeypatch)
    args, (lo, hi) = calls[0]
    got_lo, got_hi = replay(*args)
    assert _same(got_lo, lo) and _same(got_hi, hi)
    if case == 6:
        assert torch.isnan(y).all()


def test_radii_over_eight_decades(monkeypatch):
    """Random models at radii from 1e-4 to 1e4 (two per decade at least),
    both dtypes: the rounds end where the 64 steps end."""
    for dtype in (torch.float64, torch.float32):
        model, radius = sk.random_models(400, dtype, seed=11)
        r = radius[7:].double().log10()
        assert r.min() < -3.5 and r.max() > 3.5
        assert all(((r >= d) & (r < d + 1)).sum() >= 2 for d in range(-4, 4))
        calls, _ = _bisections(model, radius, monkeypatch)
        args, (lo, hi) = calls[0]
        got_lo, got_hi = replay(*args)
        assert _same(got_lo, lo) and _same(got_hi, hi)
