"""Background capture daemon for the bench's device children.

Turns any window in which the card answers into an artifact:

  loop:
    probe (one bf16 product, bounded)  -- python -m volcano_tpu_torch.bench --probe-child
    on success:
      run flash + train benches        -- python -m volcano_tpu_torch.bench --*-child
      write GPU_RESULTS.json with RAW timestamped subprocess output
      exit 0
    on failure: sleep with capped backoff, try again

The artifact names the card and its power limit as `nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader` gives them.  It is
written under build/ (ignored by git) unless --out names another path;
the bench never reads it in place of a live run.

Run detached:  nohup python -m volcano_tpu_torch.tools.gpu_watch [--once] [--out FILE] > gpu_watch.log 2>&1 &
"""

from __future__ import annotations

import datetime
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT = os.path.join(REPO, "build", "GPU_RESULTS.json")

PROBE_TIMEOUT_S = 150.0
FLASH_TIMEOUT_S = 420.0
TRAIN_TIMEOUT_S = 900.0
SLEEP_MIN_S, SLEEP_MAX_S = 120, 600


def _utcnow() -> str:
    return datetime.datetime.now(datetime.timezone.utc).isoformat()


def _child(flag: str, timeout_s: float) -> dict:
    """One bench child on the card: returns the parsed JSON line plus
    the raw stdout/stderr and wall time (the raw output IS the
    evidence — the artifact preserves it verbatim)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    t0 = time.time()
    started = _utcnow()
    proc = subprocess.Popen(
        [sys.executable, "-m", "volcano_tpu_torch.bench", flag],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=REPO)
    try:
        raw_out, raw_err = proc.communicate(timeout=timeout_s)
        rc = proc.returncode
    except subprocess.TimeoutExpired:
        # kill then DRAIN (subprocess.run loses the pipes on POSIX
        # timeouts): a mid-sweep timeout still yields the cumulative
        # lines printed so far
        proc.kill()
        try:
            raw_out, _ = proc.communicate(timeout=10)
        except Exception:  # noqa: BLE001
            raw_out = ""
        raw_err = f"timeout after {timeout_s:g}s"
        rc = -1
    wall = round(time.time() - t0, 1)
    parsed = None
    for line in reversed((raw_out or "").strip().splitlines() or [""]):
        if line.startswith("{"):
            try:
                parsed = json.loads(line)
                break
            except json.JSONDecodeError:
                continue    # the kill can truncate the final line
    return {"flag": flag, "started_utc": started, "wall_s": wall,
            "rc": rc, "parsed": parsed,
            "raw_stdout": (raw_out or "")[-4000:],
            "raw_stderr": (raw_err or "")[-2000:]}


def capture() -> dict | None:
    """One full capture attempt; returns the artifact on success."""
    probe = _child("--probe-child", PROBE_TIMEOUT_S)
    if not (probe["parsed"] or {}).get("gpu_available"):
        print(f"[{_utcnow()}] probe down: rc={probe['rc']} "
              f"err={probe['raw_stderr'][-120:]!r}", flush=True)
        return None
    print(f"[{_utcnow()}] GPU ALIVE ({probe['parsed'].get('nvidia_smi')})"
          f" — running benches", flush=True)
    flash = _child("--flash-child", FLASH_TIMEOUT_S)
    train = _child("--train-child", TRAIN_TIMEOUT_S)
    head = subprocess.run(["git", "rev-parse", "HEAD"], cwd=REPO,
                          capture_output=True, text=True).stdout.strip()
    return {
        "captured_utc": _utcnow(),
        "git_head": head,
        "device_kind": probe["parsed"].get("device_kind"),
        "nvidia_smi": probe["parsed"].get("nvidia_smi"),
        "probe": probe, "flash_attention": flash, "train_step": train,
    }


def main() -> int:
    once = "--once" in sys.argv
    out = sys.argv[sys.argv.index("--out") + 1] if "--out" in sys.argv \
        else OUT
    sleep_s = SLEEP_MIN_S
    while True:
        art = capture()
        if art is not None:
            os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
            tmp = out + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(art, f, indent=1)
            os.replace(tmp, out)
            flash_p = art["flash_attention"]["parsed"] or {}
            train_p = art["train_step"]["parsed"] or {}
            print(f"[{_utcnow()}] captured -> {out}: "
                  f"flash_mfu={flash_p.get('kernel_fwd_mfu')} "
                  f"train_mfu={train_p.get('mfu')} "
                  f"tokens/s={train_p.get('tokens_per_s')}", flush=True)
            return 0
        if once:
            return 1
        time.sleep(sleep_s)
        sleep_s = min(SLEEP_MAX_S, int(sleep_s * 1.7))


if __name__ == "__main__":
    sys.exit(main())
