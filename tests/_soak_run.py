"""Run the port's soak as a user would, for the soak scenario tests."""

import os
import signal
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
MODULE = "implicitglobalgrid_tpu_torch.scripts.soak"


def run_soak(argv, workdir, *, limit: float):
    """``python -m ...soak *argv --workdir workdir`` in its own process
    group under a hard ``limit`` in seconds: past it the whole group (the
    orchestrator and every child) is killed and the run fails, so a hang
    never runs into the suite's clock.  Returns ``(exit code, output)``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    proc = subprocess.Popen([sys.executable, "-m", MODULE, *argv, "--workdir", str(workdir)],
                            cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=limit)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"soak {argv} passed its {limit} s limit:\n{out[-6000:]}")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    return proc.returncode, out
