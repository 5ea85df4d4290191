"""The paper's headline figures on the port: the policy speedup grids
(Figs. 5-6), the block/single speedup ratios (Figs. 8-9) and the
migration-count slice (Fig. 10).

    PYTHONPATH=src python -m repro_torch.figures [--smoke]

Each function returns the rows of the reference's benchmark of the same
figure (``benchmarks/fig5_fig6_policy_speedups.py``, ``fig8_fig9_ratio.py``
and ``fig10_migration_counts.py``): ``(label, value, note)``, from the
port's simulator over the same grids.  Nothing here touches a device: the
simulator replays the interaction traces on a modeled clock.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import TRACES, policy_grid, simulate, synthetic_loops_trace

# Figs. 5-6: the (migration time x remote speedup) grid
FIG56_MIGRATION_TIMES = [0.1, 0.3, 0.5, 0.9, 1.0, 2.0, 5.0, 10.0, 30.0]
FIG56_REMOTE_SPEEDUPS = [2, 5, 10, 25, 50, 100, 150, 200]
# Figs. 8-9
FIG89_MIGRATION_TIMES = [0.1, 0.5, 1.0, 2.0, 5.0, 10.0]
FIG89_REMOTE_SPEEDUPS = [2, 10, 50, 150]
# Fig. 10: a slice of Fig. 8 at one remote speedup
FIG10_MIGRATION_TIMES = [0.1, 0.3, 0.5, 0.7, 0.9, 1.0, 1.5, 2.0, 3.0, 5.0]
FIG10_REMOTE_SPEEDUP = 150

Row = tuple[str, float, str]


def fig5_fig6(smoke: bool = False) -> list[Row]:
    """Speedup grids for block-cell and single-cell migration, both traces;
    each grid point goes through a two-env registry (``use_registry``)."""
    rows = []
    mig_times = FIG56_MIGRATION_TIMES if not smoke else [1.0]
    speedups = FIG56_REMOTE_SPEEDUPS if not smoke else [50]
    for tname, maker in TRACES.items():
        tr = maker()
        fig = "fig5" if tname == "synthetic-loops" else "fig6"
        grid = policy_grid(tr, mig_times, speedups, use_registry=True)
        for p in ("single", "block"):
            sp = np.array(grid["speedup"][p])
            rows.append((f"{fig}/{tname}/{p}/max_speedup", float(sp.max()),
                         "corner: min mig time, max remote speedup"))
            rows.append((f"{fig}/{tname}/{p}/min_speedup", float(sp.min()), ""))
            # the paper's headline operating point: block-cell gains up to 3.25x
            i, j = mig_times.index(1.0), speedups.index(50)
            rows.append((f"{fig}/{tname}/{p}/speedup@mig1s_rs50",
                         float(sp[i, j]), "paper reports gains up to 3.25x"))
        blk = np.array(grid["speedup"]["block"])
        sng = np.array(grid["speedup"]["single"])
        rows.append((f"{fig}/{tname}/block_ge_single_everywhere",
                     float((blk >= sng * 0.999).all()),
                     "paper: block outperforms single for ALL combinations"))
    return rows


def fig8_fig9(smoke: bool = False) -> list[Row]:
    """Block-cell/single-cell speedup ratios over the grid, both traces."""
    rows = []
    mig_times = FIG89_MIGRATION_TIMES if not smoke else [0.5, 5.0]
    speedups = FIG89_REMOTE_SPEEDUPS if not smoke else [2, 150]
    for tname, maker in TRACES.items():
        tr = maker()
        fig = "fig8" if tname == "synthetic-loops" else "fig9"
        grid = policy_grid(tr, mig_times, speedups)
        blk = np.array(grid["speedup"]["block"])
        sng = np.array(grid["speedup"]["single"])
        ratio = blk / np.maximum(sng, 1e-9)
        rows.append((f"{fig}/{tname}/ratio_max", float(ratio.max()), ""))
        # paper: ratio ~1 at small remote speedup, rises with speedup
        lo = ratio[:, 0].mean()
        hi = ratio[:, -1].mean()
        rows.append((f"{fig}/{tname}/ratio@low_speedup", float(lo),
                     "paper: close to one when remote speedup is small"))
        rows.append((f"{fig}/{tname}/ratio@high_speedup", float(hi),
                     "paper: rises as the speedup increases"))
        rows.append((f"{fig}/{tname}/ratio_monotone_in_speedup",
                     float(hi >= lo), ""))
    return rows


def fig10(smoke: bool = False) -> list[Row]:
    """The block/single ratio and both policies' migration counts against
    migration time, on the synthetic-loops trace at remote speedup 150."""
    rows = []
    mig_times = FIG10_MIGRATION_TIMES if not smoke else FIG10_MIGRATION_TIMES[:2]
    tr = synthetic_loops_trace()
    local = simulate(tr, "local", migration_time=0, remote_speedup=1)
    prev_key = None
    for mt in mig_times:
        blk = simulate(tr, "block", migration_time=mt,
                       remote_speedup=FIG10_REMOTE_SPEEDUP)
        sng = simulate(tr, "single", migration_time=mt,
                       remote_speedup=FIG10_REMOTE_SPEEDUP)
        ratio = (local.total_seconds / blk.total_seconds) / max(
            local.total_seconds / sng.total_seconds, 1e-9)
        key = (blk.migrations, sng.migrations)
        note = ("migration counts constant -> ratio keeps rising with mig time"
                if key == prev_key else "migration-count regime change")
        rows.append((f"fig10/mig{mt}s/ratio", ratio, note))
        rows.append((f"fig10/mig{mt}s/block_migrations", blk.migrations, ""))
        rows.append((f"fig10/mig{mt}s/single_migrations", sng.migrations, ""))
        prev_key = key
    return rows


FIGURES = {"fig5_fig6": fig5_fig6, "fig8_fig9": fig8_fig9, "fig10": fig10}


def run(smoke: bool = False) -> list[Row]:
    """Every figure's rows, in the order of ``FIGURES``."""
    return [row for fn in FIGURES.values() for row in fn(smoke)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="one grid point per figure (about a second)")
    args = ap.parse_args(argv)
    for name, val, note in run(args.smoke):
        print(f"{name},{val},{note}")


if __name__ == "__main__":
    main()
