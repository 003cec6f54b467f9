"""Terminal plotting of training metrics CSVs.

Parity with `medical_image_segmentation/analyze_data/plot_metrics_in_terminal.py:16-41`
(concat lightning metrics.csv files, sort by epoch/step, plot chosen column)
— rendered as a pure-ASCII chart so it works in SLURM logs without plotext.
"""

from __future__ import annotations

import argparse
import csv
import glob
import sys
from typing import List, Optional, Sequence, Tuple


def load_metric(csv_paths: Sequence[str], metric: str) -> Tuple[List[float], List[float]]:
    xs, ys = [], []
    for path in csv_paths:
        with open(path) as f:
            for row in csv.DictReader(f):
                v = row.get(metric, "")
                if v not in ("", None):
                    step = float(row.get("step", len(xs)))
                    xs.append(step)
                    ys.append(float(v))
    order = sorted(range(len(xs)), key=lambda i: xs[i])
    return [xs[i] for i in order], [ys[i] for i in order]


def ascii_plot(xs: Sequence[float], ys: Sequence[float], width: int = 78, height: int = 18,
               ylim: Optional[Tuple[float, float]] = None, title: str = "") -> str:
    if not ys:
        return "(no data)"
    lo = ylim[0] if ylim else min(ys)
    hi = ylim[1] if ylim else max(ys)
    if hi <= lo:
        hi = lo + 1e-9
    grid = [[" "] * width for _ in range(height)]
    n = len(ys)
    for i, y in enumerate(ys):
        col = int(i * (width - 1) / max(n - 1, 1))
        row = int((1.0 - (min(max(y, lo), hi) - lo) / (hi - lo)) * (height - 1))
        grid[row][col] = "*"
    lines = [title] if title else []
    for r, row in enumerate(grid):
        label = hi - r * (hi - lo) / (height - 1)
        lines.append(f"{label:10.4f} |" + "".join(row))
    lines.append(" " * 11 + "+" + "-" * width)
    lines.append(f"{'step':>11} {xs[0]:.0f} .. {xs[-1]:.0f}  ({n} points)")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="Plot a metrics.csv column in the terminal")
    ap.add_argument("--log_glob", default="logs/lightning_logs/version_*/metrics.csv")
    ap.add_argument("--metric", default="loss")
    ap.add_argument("--ymin", type=float, default=None)
    ap.add_argument("--ymax", type=float, default=None)
    args = ap.parse_args(argv)
    paths = sorted(glob.glob(args.log_glob))
    if not paths:
        print(f"no metrics files match {args.log_glob}", file=sys.stderr)
        return 1
    xs, ys = load_metric(paths, args.metric)
    ylim = (args.ymin, args.ymax) if args.ymin is not None and args.ymax is not None else None
    print(ascii_plot(xs, ys, ylim=ylim, title=args.metric))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
