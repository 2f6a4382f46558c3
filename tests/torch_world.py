"""Run a ``torch.distributed`` world of CPU ranks for the port's mesh tests.

``run_world(tmp_dir, n, body)`` starts ``n`` Python processes, each
joining a ``gloo`` world through a ``FileStore`` under ``tmp_dir`` (no
fixed port, so concurrent test workers do not collide), with one torch
thread.  ``body`` runs in each with ``RANK``, ``WORLD``, ``DIR`` (the
directory) and ``OUT`` (a dict) defined; each rank's ``OUT`` comes back,
saved with ``torch.save``.
"""

import os
import subprocess
import sys
import textwrap
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PRELUDE = """
import os, sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.launch.mesh import init_world
RANK = int(os.environ["WORLD_RANK"])
WORLD = int(os.environ["WORLD_SIZE_N"])
DIR = os.environ["WORLD_DIR"]
init_world(os.path.join(DIR, "store"), RANK, WORLD, "cpu")
OUT = {}
"""

_EPILOGUE = """
torch.save(OUT, os.path.join(DIR, f"rank{RANK}.pt"))
dist.barrier()
dist.destroy_process_group()
"""


def run_world(tmp_dir, n: int, body: str, timeout: float = 600.0) -> list:
    tmp_dir = str(tmp_dir)
    os.makedirs(tmp_dir, exist_ok=True)
    code = _PRELUDE + textwrap.dedent(body) + _EPILOGUE
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               WORLD_SIZE_N=str(n), WORLD_DIR=tmp_dir, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs, logs = [], []
    for r in range(n):
        log = open(os.path.join(tmp_dir, f"rank{r}.log"), "w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], env=dict(env, WORLD_RANK=str(r)),
            cwd=ROOT, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        # a rank that fails stops the others at once (they would wait in
        # a collective until the store's timeout)
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    bad = []
    for r, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        if p.returncode != 0:
            bad.append((r, p.returncode, log.read()[-3000:]))
        log.close()
    assert not bad, bad
    return [torch.load(os.path.join(tmp_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(n)]
