"""Local multi-process launcher (counterpart of the ``LocalCluster`` of
``tpuframe/launch/launcher.py``): the ``horovodrun -np N`` of one host.

:class:`LocalCluster` spawns N local processes of the same command, each
with the environment :mod:`tpuframe_torch.parallel.bootstrap` reads
(``TPUFRAME_COORDINATOR``, ``TPUFRAME_NUM_PROCESSES``,
``TPUFRAME_PROCESS_ID``), so that ``python -m tpuframe_torch.train``, or
any script that calls ``hvd.init()``, runs as an N-rank world.  On the CPU
pass ``extra_env={"TPUFRAME_DIST_BACKEND": "gloo"}`` or ``--device cpu``
to the trainer.

The JAX launcher's ``devices_per_process`` and XLA flags have no meaning
here (one process a card), and ``SliceLauncher``, ``run_with_relaunch``
and the command line are not ported yet (ROADMAP.md queue 1, item 11).
"""

from __future__ import annotations

import os
import socket
import subprocess
import tempfile
import time
from dataclasses import dataclass, field

# A rank that fails usually takes the others down within seconds (their
# collectives lose a peer); past this grace the launcher kills them.
FAILURE_GRACE_S = 10.0


def _free_port() -> int:
    """A free TCP port on the loopback interface."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@dataclass
class CompletedProcess:
    process_id: int
    returncode: int
    stdout: str
    stderr: str


@dataclass
class LocalCluster:
    """Spawn ``num_processes`` local ranks of one command."""

    num_processes: int = 2
    timeout: float = 600.0
    extra_env: dict[str, str] = field(default_factory=dict)

    def launch(self, argv: list[str]) -> list[CompletedProcess]:
        """Run ``argv`` (e.g. ``[sys.executable, "-m",
        "tpuframe_torch.train", ...]``) once a rank and wait for every
        rank.  Raises ``RuntimeError`` with every rank's tail if any rank
        exits non-zero or the run outlasts ``timeout``; no process
        outlives the call."""
        port = _free_port()
        procs, files = [], []
        try:
            for pid in range(self.num_processes):
                env = dict(os.environ)
                env.update({
                    "TPUFRAME_COORDINATOR": f"127.0.0.1:{port}",
                    "TPUFRAME_NUM_PROCESSES": str(self.num_processes),
                    "TPUFRAME_PROCESS_ID": str(pid),
                })
                env.update(self.extra_env)
                out, err = tempfile.TemporaryFile(), tempfile.TemporaryFile()
                files += [out, err]
                procs.append(subprocess.Popen(argv, env=env, stdout=out,
                                              stderr=err))
            status = self._wait(procs)
            _kill(procs)
            results = []
            for pid, p in enumerate(procs):
                out, err = files[2 * pid], files[2 * pid + 1]
                results.append(CompletedProcess(
                    pid, p.returncode, _read(out), _read(err)))
        finally:
            _kill(procs)
            for f in files:
                f.close()
        failures = [r for r in results if r.returncode != 0]
        if status or failures:
            detail = "\n".join(
                f"--- rank {r.process_id} (exit {r.returncode}) ---\n"
                f"{r.stdout[-2000:]}{r.stderr[-2000:]}" for r in results)
            raise RuntimeError(f"local cluster {status or 'failed'}:\n"
                               f"{detail}")
        return results

    def _wait(self, procs) -> str:
        """Wait for every rank; kill the rest once one has failed and the
        grace has passed, or at the timeout.  Returns "" or what went
        wrong."""
        deadline = time.monotonic() + self.timeout
        failed_at = None
        while True:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes):
                return ""
            now = time.monotonic()
            if failed_at is None and any(c not in (None, 0) for c in codes):
                failed_at = now
            if failed_at is not None and now - failed_at > FAILURE_GRACE_S:
                return (f"ranks still running {FAILURE_GRACE_S:g} s after "
                        f"a rank failed: killed")
            if now > deadline:
                return f"timed out after {self.timeout:g} s"
            time.sleep(0.05)


def _kill(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _read(f) -> str:
    f.seek(0)
    return f.read().decode(errors="replace")
