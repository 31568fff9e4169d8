"""Multi-process drives: one process per rank, as ``torchrun`` would start them.

`spawn` starts ``nprocs`` Python processes running this module on a JSON
task, each with its own ``RANK``/``WORLD_SIZE``/``MASTER_PORT`` environment,
waits for all of them under a timeout, and kills the rest if one fails.  A
worker brings the grid up through `init_global_grid` (which joins the
process group), cuts its block out of the task's global-block numpy inputs,
runs the task and saves its result blocks as ``out_rank<r>.npz``.  The
worker imports torch, numpy and this package only.

Tasks:

* ``"halo"``: `update_halo(*fields, width=...)` on the named fields.
* ``"multi_step"``, ``"acoustic"``, ``"porous"``: ``make_multi_step(params,
  nsteps, ...)`` of ``diffusion3d`` on ``(T, Cp)``, of ``acoustic3d`` on
  ``(P, Vx, Vy, Vz)``, of ``porous_convection3d`` on ``(T, Pf, qDx, qDy,
  qDz)``; every field of the final state is saved.

Run one rank by hand with ``python -m implicitglobalgrid_tpu_torch._workers
TASK.json`` and the environment variables above set.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

_REPO_ROOT = Path(__file__).resolve().parent.parent


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(task: dict, nprocs: int, workdir, *, timeout: float = 120.0) -> list[dict]:
    """Run ``task`` on ``nprocs`` ranks; return each rank's saved arrays.

    ``task["inputs"]`` maps names to numpy arrays; it is written to
    ``workdir`` beside the task file.  Raises with the workers' output if
    any rank fails or the timeout passes.
    """
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    task = dict(task)
    np.savez(workdir / "inputs.npz", **task.pop("inputs"))
    task["workdir"] = str(workdir)
    (workdir / "task.json").write_text(json.dumps(task))
    port = free_port()
    procs = []
    for r in range(nprocs):
        env = dict(os.environ)
        env.update(
            RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(nprocs),
            MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
            PYTHONPATH=os.pathsep.join(
                [str(_REPO_ROOT)] + [p for p in [env.get("PYTHONPATH")] if p]
            ),
        )
        log = open(workdir / f"rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "implicitglobalgrid_tpu_torch._workers",
             str(workdir / "task.json")],
            env=env, stdout=log, stderr=subprocess.STDOUT,
        ), log))
    failed = None
    deadline = time.monotonic() + timeout
    try:
        # Poll every rank: a rank that dies leaves its peers blocked in a
        # collective, so the first failure ends the run.
        while True:
            rcs = [p.poll() for p, _ in procs]
            if any(rc not in (None, 0) for rc in rcs):
                failed = rcs
                break
            if all(rc == 0 for rc in rcs):
                break
            if time.monotonic() > deadline:
                failed = f"timeout after {timeout} s (exit codes {rcs})"
                break
            time.sleep(0.05)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    if failed:
        logs = "\n".join(
            f"--- rank {r} ---\n" + (workdir / f"rank{r}.log").read_text()
            for r in range(nprocs)
        )
        raise RuntimeError(f"workers failed ({failed}):\n{logs}")
    return [dict(np.load(workdir / f"out_rank{r}.npz")) for r in range(nprocs)]


def _run(task: dict) -> dict:
    import torch

    from . import finalize_global_grid, init_global_grid, update_halo
    from .models import acoustic3d, diffusion3d, porous_convection3d
    from .utils.fields import block_from_numpy

    models = {
        "multi_step": (diffusion3d, ("T", "Cp")),
        "acoustic": (acoustic3d, ("P", "Vx", "Vy", "Vz")),
        "porous": (porous_convection3d, ("T", "Pf", "qDx", "qDy", "qDz")),
    }

    dtypes = {"float32": torch.float32, "float64": torch.float64}
    workdir = Path(task["workdir"])
    inputs = dict(np.load(workdir / "inputs.npz"))
    init_global_grid(*task["nxyz"], device="cpu", quiet=True, **task.get("grid", {}))
    try:
        if task["kind"] == "halo":
            fields = [
                block_from_numpy(inputs[name], tuple(shape))
                for name, shape in zip(task["fields"], task["shapes"])
            ]
            update_halo(*fields, width=task.get("width", 1))
            return {name: A.numpy() for name, A in zip(task["fields"], fields)}
        if task["kind"] in models:
            model, names = models[task["kind"]]
            kw = dict(task["params"])
            kw["dtype"] = dtypes[kw["dtype"]]
            params = model.Params(**kw)
            state = model.state_from_numpy(*(inputs[n] for n in names))
            state = model.make_multi_step(params, task["nsteps"], **task.get("step", {}))(*state)
            return {n: a.numpy() for n, a in zip(names, state)}
        raise ValueError(f"unknown task kind {task['kind']!r}")
    finally:
        finalize_global_grid()


def main(argv: list[str]) -> int:
    task = json.loads(Path(argv[0]).read_text())
    out = _run(task)
    if "jax" in sys.modules:
        raise RuntimeError("a port worker imported jax")
    rank = int(os.environ["RANK"])
    np.savez(Path(task["workdir"]) / f"out_rank{rank}.npz", **out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
