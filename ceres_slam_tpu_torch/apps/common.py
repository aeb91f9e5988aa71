"""Shared app plumbing (port of ``ceres_slam_tpu/apps/common.py``)."""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

import torch

from ceres_slam_tpu_torch.utils import device, telemetry


def base_parser(desc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' fails when no card is present "
                        "(run on the CPU only with --device cpu)")
    # reference iteration budget: max_num_iterations = 1000
    p.add_argument("--max-iters", type=int, default=1000,
                   help="max trust-region iterations per solve")
    p.add_argument("--report", default="none", choices=["none", "brief", "full"],
                   help="per-window solver report (Ceres Brief/FullReport equivalent; "
                        "full records the per-iteration history)")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="record the program's spans and write them (spans.json) into DIR; "
                        "no profiler runs, since WHILE nodes captured under it can fault")
    return p


def traced(args):
    """The context an app runs in: under ``--trace DIR``, the program's
    spans recorded (``telemetry.record``) into ``DIR/spans.json``; else
    nothing."""
    if not args.trace:
        return contextlib.nullcontext()
    os.makedirs(args.trace, exist_ok=True)
    return telemetry.record(os.path.join(args.trace, "spans.json"))


def resolve_device(name: str) -> torch.device:
    """The requested device; ``cuda`` without a card exits instead of
    falling back to the CPU."""
    try:
        return device.resolve(name)
    except RuntimeError:
        raise SystemExit(f"--device {name}: no CUDA device is available "
                         "(pass --device cpu to run on the CPU)") from None


def solver_tolerance(dtype: str, num_windows: int) -> float:
    """ftol/xtol matched to precision and chain length: float64 uses Ceres'
    default function tolerance 1e-6; float32 uses 1e-5 up to 256 windows
    and 1e-7 beyond, where per-window early stops would accumulate along
    the chain. ``num_windows`` is the pass's window count."""
    if dtype == "float64":
        return 1e-6
    return 1e-5 if num_windows <= 256 else 1e-7


def print_reports(summaries, mode: str, file=None) -> None:
    """Per-window solver reports: ``brief`` one line each, ``full`` the
    per-iteration history too (the solves must record it)."""
    if mode == "none":
        return
    file = file or sys.stderr
    fmt = telemetry.full_report if mode == "full" else telemetry.brief_report
    for i, s in enumerate(summaries):
        print(f"[window {i}] {fmt(s)}", file=file)
