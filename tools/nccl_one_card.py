#!/usr/bin/env python3
"""Two NCCL ranks on one card: the error NCCL gives.

    python3 tools/nccl_one_card.py

Starts a world of two ranks under ``python -m torch.distributed.run``, both
bound to ``cuda:0``, and runs one ``all_reduce``. Prints each rank's error
and the card (``nvidia-smi``'s name and power limit), and exits 0 if every
rank failed, 1 if the all-reduce ran. This is why a phase that needs
several ranks (``chip_smoke.py``'s ``collectives``) does not run on one
card. Needs one card; stops every process it starts within 180 s.
"""
from __future__ import annotations

import datetime
import os
import signal
import subprocess
import sys


def worker() -> None:
    import torch
    import torch.distributed as dist

    rank = int(os.environ["RANK"])
    try:
        dist.init_process_group("nccl", timeout=datetime.timedelta(seconds=60),
                                device_id=torch.device("cuda", 0))
        t = torch.ones(1024, device="cuda:0")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        print(f"rank {rank}: all_reduce ran, sum {float(t[0])}", flush=True)
    except Exception as e:          # the error is what this tool reports
        print(f"rank {rank}: {type(e).__name__}: {e}", flush=True)
        sys.exit(3)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def main() -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
           os.path.abspath(__file__), "--worker"]
    env = dict(os.environ, NCCL_DEBUG="WARN")      # NCCL's own reason, not only its code
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            env=env, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=180)
    except subprocess.TimeoutExpired:
        out = "timed out after 180 s"
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
    lines = [line for line in out.splitlines()
             if line.startswith("rank ") or "NCCL WARN" in line]
    for line in lines:
        print(line[:2000])
    ran = any("all_reduce ran" in line for line in lines)
    print(out[-3000:] if not lines else "", end="")
    return 1 if ran or not lines else 0


if __name__ == "__main__":
    if "--worker" in sys.argv:
        worker()
    else:
        sys.exit(main())
