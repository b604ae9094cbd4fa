"""Extended churn-fuzz sweep — many seeds of the whole-scheduler
contention pipeline with per-cycle invariants.

tests/test_torch_fuzz.py runs the reference's 4 fixed seeds; this tool
widens the search (hundreds of seeds, longer episodes, a mixed-queue
weight flip thrown in) for soak-style bug hunting between rounds.
Any violation prints the seed + step so the failure is replayable in
the unit test by adding that seed.  The episode is
volcano_tpu_torch/tools/churn.py's, on the mirrored GPU cluster.

Usage: python -m volcano_tpu_torch.tools.fuzz_sweep [n_seeds] [steps]   # default 150 80
"""
import os
import random
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)

from volcano_tpu_torch.tools.churn import churn_episode  # noqa: E402


def main() -> int:
    n_seeds = int(sys.argv[1]) if len(sys.argv) > 1 else 150
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 80
    t0 = time.time()
    base = random.Random(int(os.environ.get("FUZZ_BASE", "515")))
    seeds = [base.randrange(1 << 30) for _ in range(n_seeds)]
    for i, seed in enumerate(seeds):
        try:
            churn_episode(seed, steps=steps,
                          gang_sizes=(1, 2, 4, 4, 8, 16),
                          p_new=0.5, p_del=0.7, p_prio=0.8,
                          p_weight=0.88)
        except Exception:
            # ANY crash gets the replay line, not just invariant
            # assertions — the seed is otherwise unrecoverable
            print(f"VIOLATION seed={seed}", flush=True)
            raise
        if (i + 1) % 10 == 0:
            print(f"{i + 1}/{n_seeds} seeds clean "
                  f"({time.time() - t0:.0f}s)", flush=True)
    print(f"OK: {n_seeds} seeds x {steps} steps, no invariant "
          f"violations ({time.time() - t0:.0f}s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
