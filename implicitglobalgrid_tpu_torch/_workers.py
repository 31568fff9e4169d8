"""Multi-process drives: one process per rank, as ``torchrun`` would start them.

`spawn` starts ``nprocs`` Python processes running this module on a JSON
task, each with its own ``RANK``/``WORLD_SIZE``/``MASTER_PORT`` environment,
waits for all of them under a timeout, and kills the rest if one fails.  A
worker brings the grid up through `init_global_grid` (which joins the
process group), cuts its block out of the task's global-block numpy inputs,
runs the task and saves its result blocks as ``out_rank<r>.npz``.  The
worker imports torch, numpy and this package only.

Tasks:

* ``"halo"``: `update_halo(*fields, width=...)` on the named fields; with
  ``"split": true`` also `begin_slab_exchange` + `finish_slab_exchange` on
  copies of them, saved as ``<name>_split``.
* ``"multi_step"``, ``"acoustic"``, ``"porous"``: ``make_multi_step(params,
  nsteps, **step)`` of ``diffusion3d`` on ``(T, Cp)``, of ``acoustic3d`` on
  ``(P, Vx, Vy, Vz)``, of ``porous_convection3d`` on ``(T, Pf, qDx, qDy,
  qDz)``; every field of the final state is saved.  ``"steps"``: a list of
  such ``step`` keyword sets (``fused_k``, ``fused_tile``, ``pipelined``,
  ...; ``hide_comm`` sets the params' flag), each run from the same inputs
  and saved as ``<name><i>``.
* ``"batched"``: ensembles (`models._batched`).  Each entry of ``runs``
  names a ``model`` (one of the kinds above), its ``params``, ``nsteps``,
  ``batch`` B, a ``steps`` list and a ``prefix``; member ``b``'s inputs are
  ``<prefix><name>@<b>``.  The worker stacks the members, runs
  ``make_multi_step(..., batch=True, **step)`` once per step and each member
  alone, and saves member ``b`` of the batched result as
  ``<prefix><name><i>@<b>`` and the member's own run as
  ``<prefix><name><i>@<b>u``, the ``P2POp``s the batched run issued per
  grid dimension as ``<prefix>p2p<i>``, and for porous runs the batched
  result's `make_batched_residual` as ``<prefix>res<i>``.  With
  ``finite_probe`` (``{"rank": r, "member": m}``) it then poisons member
  ``m`` of the first run's inputs on rank ``r`` alone and saves
  `check_members_finite` as ``finite``.

* ``"grad"``: gradients through the exchange and the model cadences.  Each
  entry of ``runs`` (inputs ``<prefix><name>``) names a ``model``: one of
  the kinds above, run as ``make_multi_step(params, nsteps, **step)`` (or
  ``make_step(params)`` with ``"make_step": true``), or ``"halo"``,
  ``update_halo`` of copies of the ``fields`` (their block ``shapes``)
  with ``width`` and ``coalesce``.  The loss is ``scale`` times the sum
  over ranks of ``sum(out**2)`` over the outputs named in ``loss``
  (default: all); each rank saves its gradient blocks w.r.t. the fields in
  ``wrt`` as ``<prefix>d<name>``, its outputs as ``<prefix><name>``, and the
  ``P2POp``s issued per dimension by the forward and by the backward as
  ``<prefix>p2p`` (x, y, z forward, then x, y, z backward).  With
  ``fd_points`` (``[rank, name, index]`` each) it also saves the central
  differences (step ``eps``) of the all-reduced loss at those points as
  ``<prefix>fd``.  ``env`` sets environment variables for the run alone
  (e.g. ``IGG_COALESCE``); a halo run with ``"split": true`` also runs
  `begin_slab_exchange` + `finish_slab_exchange` on copies, saved as
  ``<prefix><name>_split`` with its ``P2POp``s as ``<prefix>p2p_split``.

* ``"resilience"``: a list of ``actions`` run in order, each saving its
  results under its ``prefix`` (``p``).  ``{"do": "grid", "nxyz",
  "grid"}`` (re)initializes the grid, keeping the process group.  The
  others cut their ``fields`` from the inputs at ``shapes`` (``batched``
  maps a field to its B, its inputs being ``<name>@<b>``): ``"save"``
  writes `save_checkpoint` at ``path``/``step``; ``"restore"`` saves this
  rank's blocks of `restore_checkpoint` ``(path)`` as ``<p><i>`` (with
  ``"gather": true`` also their de-duplicated gathers as ``<p>g<i>``);
  ``"gather"`` saves `gather` ``(dedup=True)`` on rank 0 as
  ``<p><name>`` (member ``m`` of a batched field as ``<p><name>@<m>``);
  ``"check"`` poisons field 0 on rank ``rank`` and saves the
  `check_fields` bad blocks as ``<p>bad``; ``"audit"`` flips bit 0 of one
  word of a copy of field 0 on rank ``rank`` and saves `audit_fields`'s
  implicated ranks as ``<p>ranks``; ``"transport"`` saves whether an
  ``IGG_INTEGRITY=1`` exchange equals the unchecked one as ``<p>same``,
  then arms ``arm_transport_flip(rank)`` and saves ``[detector raised,
  implicated rank]`` as ``<p>flip``.  ``"run"`` runs ``diffusion3d.run``
  on ``args`` ``(nt, nx, ny, nz)`` with ``kw`` under ``env`` and saves
  this rank's T as ``<p>T`` (a ``worker_crash`` fault ends the process
  there).

* ``"serving"``: the serving front door over a diffusion pool
  (`serving.FrontDoor`).  `serving.frontdoor.broadcast_control` of rank
  0's ``message`` (the others pass None), saved as ``bcast`` (JSON bytes),
  and of nothing, saved as ``bcast_empty``; then a `ServingLoop`
  (``capacity``, ``steps_per_round``) behind a door: rank 0 hands each
  entry of ``specs`` to ``handle_submit``, every rank runs
  ``serve_rounds(rounds)``, rank 0 saves each request's result view as
  ``results`` (JSON bytes), then asks for a shutdown and saves the
  outcome of the next ``serve_rounds`` as ``outcome``.

* ``"tracing"``: the cross-rank half of `utils.tracing` under
  ``IGG_TELEMETRY_DIR=<workdir>/tele``.  After `init_global_grid` (whose
  clock sync takes a barrier) each rank saves the sync record as ``sync``
  (JSON bytes), `all_ranks_value` of ``rank + 1`` as ``vals`` and
  `skew_probe` of ``step_s[rank]`` as ``probe`` (JSON bytes); then
  ``diffusion3d.run(nt)`` on the same grid arguments with
  ``IGG_HEARTBEAT_EVERY=heartbeat`` (the probe rides its heartbeats) and
  `dump_trace` of its spans; the parent merges ``tele/trace.p*.json``.

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

    import dataclasses

    from . import finalize_global_grid, init_global_grid, update_halo
    from .models import acoustic3d, diffusion3d, porous_convection3d
    from .ops.halo import begin_slab_exchange, finish_slab_exchange
    from .utils.fields import block_from_numpy

    models = {
        "multi_step": (diffusion3d, ("T", "Cp")),
        "acoustic": (acoustic3d, ("P", "Vx", "Vy", "Vz")),
        "porous": (porous_convection3d, ("T", "Pf", "qDx", "qDy", "qDz")),
    }

    dtypes = {"float32": torch.float32, "float64": torch.float64}
    workdir = Path(task["workdir"])
    inputs = dict(np.load(workdir / "inputs.npz"))
    if task["kind"] == "resilience":
        return _run_resilience(task, inputs)
    if task["kind"] == "serving":
        return _run_serving(task)
    if task["kind"] == "tracing":
        return _run_tracing(task)
    init_global_grid(*task["nxyz"], device="cpu", quiet=True, **task.get("grid", {}))
    try:
        if task["kind"] == "halo":
            fields = [
                block_from_numpy(inputs[name], tuple(shape))
                for name, shape in zip(task["fields"], task["shapes"])
            ]
            width = task.get("width", 1)
            out = {}
            if task.get("split"):
                copies = [A.clone() for A in fields]
                pend = begin_slab_exchange(copies, range(3), width=width)
                finish_slab_exchange(copies, pend)
                out = {f"{name}_split": A.numpy() for name, A in zip(task["fields"], copies)}
            update_halo(*fields, width=width)
            return {**out, **{name: A.numpy() for name, A in zip(task["fields"], fields)}}
        if task["kind"] in models:
            model, names = models[task["kind"]]
            kw = dict(task["params"])
            kw["dtype"] = dtypes[kw["dtype"]]
            params = model.Params(**kw)
            state = model.state_from_numpy(*(inputs[n] for n in names))
            if "steps" not in task:
                state = model.make_multi_step(params, task["nsteps"], **task.get("step", {}))(
                    *state)
                return {n: a.numpy() for n, a in zip(names, state)}
            out = {}
            for i, step in enumerate(task["steps"]):
                step = dict(step)
                p = dataclasses.replace(params, hide_comm=step.pop("hide_comm", params.hide_comm))
                got = model.make_multi_step(p, task["nsteps"], **step)(*state)
                out.update({f"{n}{i}": a.numpy() for n, a in zip(names, got)})
            return out
        if task["kind"] == "batched":
            return _run_batched(task, inputs, models, dtypes)
        if task["kind"] == "grad":
            return _run_grad(task, inputs, models, dtypes)
        raise ValueError(f"unknown task kind {task['kind']!r}")
    finally:
        finalize_global_grid()


def _run_batched(task: dict, inputs: dict, models: dict, dtypes: dict) -> dict:
    """The ``"batched"`` task (see the module docstring)."""
    import dataclasses

    from .models import _batched, porous_convection3d

    p2p = [0, 0, 0]
    restore = _count_p2p(p2p)
    out = {}
    try:
        for run in task["runs"]:
            model, names = models[run["model"]]
            kw = dict(run["params"])
            kw["dtype"] = dtypes[kw["dtype"]]
            params = model.Params(**kw)
            pre, nb = run["prefix"], run["batch"]
            members = [model.state_from_numpy(*(inputs[f"{pre}{n}@{b}"] for n in names))
                       for b in range(nb)]
            batched = _batched.stack_states(members)
            for i, step in enumerate(run["steps"]):
                step = dict(step)
                p = dataclasses.replace(params, hide_comm=step.pop("hide_comm", False))
                p2p[:] = [0, 0, 0]
                got = model.make_multi_step(p, run["nsteps"], batch=True, **step)(*batched)
                out[f"{pre}p2p{i}"] = np.array(p2p)
                for b in range(nb):
                    alone = model.make_multi_step(p, run["nsteps"], **step)(*members[b])
                    for n, g, a in zip(names, got, alone):
                        out[f"{pre}{n}{i}@{b}"] = g[b].numpy()
                        out[f"{pre}{n}{i}@{b}u"] = a.numpy()
                if model is porous_convection3d:
                    out[f"{pre}res{i}"] = porous_convection3d.make_batched_residual(p)(
                        *got).numpy()
        probe = task.get("finite_probe")
        if probe:
            run = task["runs"][0]
            model, names = models[run["model"]]
            state = _batched.stack_states([
                model.state_from_numpy(*(inputs[f"{run['prefix']}{n}@{b}"] for n in names))
                for b in range(run["batch"])])
            if int(os.environ["RANK"]) == probe["rank"]:
                state[0][probe["member"], 0, 0, 0] = float("nan")
            out["finite"] = _batched.check_members_finite(state)
    finally:
        restore()
    return out


def _count_p2p(counts):
    """Count the ``P2POp``s `torch.distributed.batch_isend_irecv` issues in
    ``counts`` (by tag: ``ops.halo._issue_permute`` tags a dim-``d``
    message ``2d`` or ``2d+1`` in the forward and ``ADJOINT_TAG`` more in
    the backward).  Returns a function that restores the original."""
    import torch.distributed as dist

    issue = dist.batch_isend_irecv

    def counted(ops):
        for op in ops:
            counts[op.tag // 2] += 1
        return issue(ops)

    dist.batch_isend_irecv = counted

    def restore():
        dist.batch_isend_irecv = issue

    return restore


def _run_grad(task: dict, inputs: dict, models: dict, dtypes: dict) -> dict:
    """The ``"grad"`` task (see the module docstring)."""
    rank = int(os.environ["RANK"])
    p2p = [0] * 6
    restore = _count_p2p(p2p)
    out = {}
    try:
        for run in task["runs"]:
            saved_env = {k: os.environ.get(k) for k in run.get("env", {})}
            os.environ.update(run.get("env", {}))
            try:
                out.update(_grad_run(run, inputs, models, dtypes, p2p, rank))
            finally:
                for k, v in saved_env.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
    finally:
        restore()
    return out


def _grad_run(run: dict, inputs: dict, models: dict, dtypes: dict, p2p: list, rank: int):
    """One entry of a ``"grad"`` task's ``runs``."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from . import update_halo
    from .ops.halo import begin_slab_exchange, finish_slab_exchange
    from .utils.fields import block_from_numpy

    pre = run["prefix"]
    out = {}
    if run["model"] == "halo":
        names = run["fields"]
        state = [block_from_numpy(inputs[pre + n], tuple(s)) for n, s in zip(names, run["shapes"])]
        width, coalesce = run.get("width", 1), run.get("coalesce")

        def fn(*fields):
            got = update_halo(*(f.clone() for f in fields), width=width, coalesce=coalesce)
            return got if isinstance(got, tuple) else (got,)

        if run.get("split"):
            p2p[:] = [0] * 6
            copies = [A.clone() for A in state]
            finish_slab_exchange(copies, begin_slab_exchange(copies, range(3), width=width,
                                                             coalesce=coalesce))
            out.update({f"{pre}{n}_split": A.numpy() for n, A in zip(names, copies)})
            out[f"{pre}p2p_split"] = np.array(p2p)
    else:
        model, names = models[run["model"]]
        kw = dict(run["params"])
        kw["dtype"] = dtypes[kw["dtype"]]
        step = dict(run.get("step", {}))
        params = dataclasses.replace(model.Params(**kw), hide_comm=step.pop("hide_comm", False))
        state = model.state_from_numpy(*(inputs[pre + n] for n in names))
        fn = (model.make_step(params) if run.get("make_step")
              else model.make_multi_step(params, run["nsteps"], **step))
    wrt, scale = run.get("wrt", names), run.get("scale", 1.0)
    loss_names = run.get("loss", names)

    def local_loss(fields):
        got = fn(*fields)
        return scale * sum((o**2).sum() for n, o in zip(names, got) if n in loss_names), got

    leaves = [A.clone().requires_grad_(n in wrt) for n, A in zip(names, state)]
    p2p[:] = [0] * 6
    loss, got = local_loss(leaves)
    grads = torch.autograd.grad(loss, [x for n, x in zip(names, leaves) if n in wrt])
    out[f"{pre}p2p"] = np.array(p2p)
    out.update({f"{pre}{n}": o.detach().numpy() for n, o in zip(names, got)})
    out.update({f"{pre}d{n}": g.numpy() for n, g in zip(wrt, grads)})
    fd = []
    eps = run.get("eps", 1e-3)
    for r, name, idx in run.get("fd_points", ()):
        sides = []
        for sign in (1, -1):
            fields = [A.clone() for A in state]
            if r == rank:
                fields[names.index(name)][tuple(idx)] += sign * eps
            with torch.no_grad():
                total = local_loss(fields)[0].reshape(1)
            dist.all_reduce(total)
            sides.append(float(total))
        fd.append((sides[0] - sides[1]) / (2 * eps))
    if fd:
        out[f"{pre}fd"] = np.array(fd)
    return out


def _run_resilience(task: dict, inputs: dict) -> dict:
    """The ``"resilience"`` task (see the module docstring)."""
    import torch

    from . import (check_fields, finalize_global_grid, gather, grid_is_initialized,
                   init_global_grid, restore_checkpoint, save_checkpoint, update_halo)
    from .integrity import IntegrityError, audit_fields
    from .models import diffusion3d
    from .ops import halo
    from .utils.fields import block_from_numpy

    rank = int(os.environ["RANK"])
    out = {}

    def fields(act):
        out = []
        for n, shape in zip(act["fields"], act["shapes"]):
            nb = act.get("batched", {}).get(n)
            out.append(block_from_numpy(inputs[n], tuple(shape)) if nb is None else torch.stack(
                [block_from_numpy(inputs[f"{n}@{b}"], tuple(shape)) for b in range(nb)]))
        return out

    def gather_dedup(key, A):
        """Rank 0 keeps `gather(dedup=True)` of ``A`` (of each member of a
        batched field, as ``<key>@<m>``)."""
        for m in range(A.shape[0]) if A.dim() > 3 else [None]:
            got = gather(A, dedup=True, member=m)
            if got is not None:
                out[key + ("" if m is None else f"@{m}")] = got

    def regrid(act=None):
        if grid_is_initialized():
            finalize_global_grid(finalize_distributed=False)
        if act is not None:
            init_global_grid(*act["nxyz"], device="cpu", quiet=True, **act.get("grid", {}))

    for act in task["actions"]:
        do, pre = act["do"], act.get("prefix", "")
        if do == "grid":
            regrid(act)
        elif do == "save":
            save_checkpoint(act["path"], fields(act), act["step"])
        elif do == "restore":
            state, _, _ = restore_checkpoint(act["path"])
            out.update({f"{pre}{i}": A.numpy() for i, A in enumerate(state)})
            for i, A in enumerate(state if act.get("gather") else ()):
                gather_dedup(f"{pre}g{i}", A)
        elif do == "gather":
            for name, A in zip(act["fields"], fields(act)):
                gather_dedup(pre + name, A)
        elif do == "check":
            A = fields(act)[0]
            if rank == act["rank"]:
                A[(1,) * A.dim()] = float("inf")
            bad = check_fields(A, names=("A",)).bad_blocks.get("A", ())
            out[pre + "bad"] = np.array(bad, dtype=np.int64).reshape(-1, 3)
        elif do == "audit":
            A = fields(act)[0]
            B = A.clone()
            if rank == act["rank"]:
                B.view(torch.int64 if B.element_size() == 8 else torch.int32)[1, 1, 1] ^= 1
            out[pre + "ranks"] = np.array(audit_fields((A,), (B,)).implicated_ranks)
        elif do == "transport":
            fs = fields(act)
            plain = update_halo(*[A.clone() for A in fs])
            os.environ["IGG_INTEGRITY"] = "1"
            try:
                checked = update_halo(*[A.clone() for A in fs])
                out[pre + "same"] = np.array(all(torch.equal(a, b)
                                                 for a, b in zip(plain, checked)))
                halo.arm_transport_flip(act["rank"])
                flip = [0, -2]
                try:
                    update_halo(*[A.clone() for A in fs])
                except IntegrityError as e:
                    flip = [int(e.detector == "transport_checksum"), e.implicated_rank]
                out[pre + "flip"] = np.array(flip)
            finally:
                del os.environ["IGG_INTEGRITY"]
        elif do == "run":
            regrid()
            saved_env = {k: os.environ.get(k) for k in act.get("env", {})}
            os.environ.update(act.get("env", {}))
            try:
                T = diffusion3d.run(*act["args"], finalize=False, quiet=True, device="cpu",
                                    dtype=torch.float64, **act.get("kw", {}))
            finally:
                for k, v in saved_env.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
            out[pre + "T"] = T.numpy()
        else:
            raise ValueError(f"unknown resilience action {do!r}")
    if grid_is_initialized():
        finalize_global_grid()
    return out


def _run_serving(task: dict) -> dict:
    """The ``"serving"`` task (see the module docstring)."""
    import torch

    from . import finalize_global_grid, init_global_grid
    from .models import diffusion3d
    from .serving import FrontDoor, ServingLoop
    from .serving.frontdoor import broadcast_control

    def as_bytes(doc):
        return np.frombuffer(json.dumps(doc, sort_keys=True).encode(), np.uint8)

    rank = int(os.environ["RANK"])
    init_global_grid(*task["nxyz"], device="cpu", quiet=True, **task.get("grid", {}))
    try:
        out = {"bcast": as_bytes(broadcast_control(task["message"] if rank == 0 else None)),
               "bcast_empty": as_bytes(broadcast_control(None))}
        _, params = diffusion3d.setup(*task["nxyz"], init_grid=False, dtype=torch.float64)
        loop = ServingLoop(diffusion3d, params, capacity=task["capacity"],
                           steps_per_round=task["steps_per_round"])
        fd = FrontDoor(loop, port=0, setup_kwargs={"dtype": torch.float64})
        try:
            rids = [fd.handle_submit(doc)[1]["request_id"] for doc in task["specs"]] \
                if rank == 0 else []
            fd.serve_rounds(max_rounds=task["rounds"])
            if rank == 0:
                out["results"] = as_bytes({rid: fd.result_view(rid) for rid in rids})
                fd.request_shutdown()
            out["outcome"] = as_bytes(fd.serve_rounds(max_rounds=2))
        finally:
            fd.close()
        return out
    finally:
        finalize_global_grid()


def _run_tracing(task: dict) -> dict:
    """The ``"tracing"`` task (see the module docstring)."""
    import torch

    from . import finalize_global_grid, init_global_grid
    from .models import diffusion3d
    from .utils import tracing

    def as_bytes(doc):
        return np.frombuffer(json.dumps(doc, sort_keys=True).encode(), np.uint8)

    rank = int(os.environ["RANK"])
    os.environ["IGG_TELEMETRY_DIR"] = str(Path(task["workdir"]) / "tele")
    grid = dict(device="cpu", quiet=True, **task.get("grid", {}))
    init_global_grid(*task["nxyz"], **grid)
    try:
        out = {"sync": as_bytes(tracing.clock_sync()),
               "vals": tracing.all_ranks_value(float(rank + 1)),
               "probe": as_bytes(tracing.skew_probe(task["step_s"][rank]))}
    finally:
        finalize_global_grid()
    os.environ["IGG_HEARTBEAT_EVERY"] = str(task["heartbeat"])
    diffusion3d.run(task["nt"], *task["nxyz"], dtype=torch.float64, **grid)
    tracing.dump_trace()
    return out


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
