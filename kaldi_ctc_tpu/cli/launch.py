"""Local multi-process SPMD launcher — the run.pl analogue.

Spawns N copies of a command with the jax.distributed environment set
(COORDINATOR_ADDRESS / PROCESS_ID / NUM_PROCESSES), so the multi-host
training path (per-host data shards, cross-process gradient allreduce
over NCCL on GPUs or Gloo on CPU) runs on one machine:

  python -m kaldi_ctc_tpu.cli.launch --num-processes 2 -- \\
      python -m kaldi_ctc_tpu.cli.train_ctc --feats ... --dir exp

Child i sees only GPU i (CUDA_VISIBLE_DEVICES): a JAX process reserves
most of every card it can see, so two processes sharing cards would run
out of memory.  On several hosts each host runs the command once
instead, making this launcher the local stand-in for the reference's
run.pl/queue.pl job spawning (utils/run.pl:7-29,
steps/ctc/train.sh:408-419).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--port", type=int, default=0,
                   help="coordinator port (0 = pick a free one, so "
                        "concurrent launches on one machine don't "
                        "cross-connect)")
    p.add_argument("cmd", nargs=argparse.REMAINDER,
                   help="command to run (prefix with --)")
    return p.parse_args(argv)


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def child_cards(num_processes: int, visible=None) -> list:
    """The one GPU each child may see: the i-th visible card (all cards
    when CUDA_VISIBLE_DEVICES is unset)."""
    cards = (visible.split(",") if visible
             else [str(i) for i in range(num_processes)])
    if num_processes > len(cards):
        raise SystemExit(f"launch: {num_processes} processes but only "
                         f"{len(cards)} visible cards ({visible})")
    return cards[:num_processes]


def main(argv=None):
    import time

    args = parse_args(argv)
    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        print("no command given", file=sys.stderr)
        sys.exit(2)
    cards = child_cards(args.num_processes,
                        os.environ.get("CUDA_VISIBLE_DEVICES"))
    port = args.port or _free_port()
    procs = []
    for pid in range(args.num_processes):
        env = dict(os.environ)
        env["COORDINATOR_ADDRESS"] = f"localhost:{port}"
        env["PROCESS_ID"] = str(pid)
        env["NUM_PROCESSES"] = str(args.num_processes)
        env["CUDA_VISIBLE_DEVICES"] = cards[pid]
        procs.append(subprocess.Popen(cmd, env=env))
    # poll instead of sequential wait: a process that dies before the
    # jax.distributed rendezvous would leave the others blocked in the
    # barrier forever — kill the survivors and fail fast instead
    rc = 0
    live = list(procs)
    try:
        while live:
            for p in list(live):
                r = p.poll()
                if r is None:
                    continue
                live.remove(p)
                if r != 0:
                    rc = rc or r
                    print(f"launch: a process exited with {r}; "
                          f"terminating the remaining "
                          f"{len(live)}", file=sys.stderr)
                    for q in live:
                        q.terminate()
                    for q in live:
                        try:
                            q.wait(timeout=10)
                        except subprocess.TimeoutExpired:
                            q.kill()
                            q.wait()
                    live = []
                    break
            time.sleep(0.1)
    finally:
        for q in live:
            q.terminate()
    sys.exit(rc)


if __name__ == "__main__":
    main()
