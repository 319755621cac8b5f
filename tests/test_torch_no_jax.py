"""The port never imports JAX or the JAX package.

In a fresh interpreter whose import system refuses ``jax``, ``jaxlib``,
``flax`` and ``tpuframe``, every module of ``tpuframe_torch`` and
``chip_smoke.py`` (with its whole import graph) must import.
"""

import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CODE = """
import importlib
import pkgutil
import sys

REFUSED = {"jax", "jaxlib", "flax", "tpuframe"}


class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError("refused " + name)
        return None


for name in list(sys.modules):   # in case site customisation loaded any
    if name.split(".")[0] in REFUSED:
        del sys.modules[name]
sys.meta_path.insert(0, Refuse())

import tpuframe_torch

names = [m.name for m in pkgutil.walk_packages(tpuframe_torch.__path__,
                                                "tpuframe_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401

assert not [n for n in sys.modules if n.split(".")[0] in REFUSED]
print(" ".join(names))
"""

# The checkpointing slice's modules, which the walk must reach.
CKPT_SLICE = {"tpuframe_torch.native", "tpuframe_torch.ckpt",
              "tpuframe_torch.ckpt.checkpoint", "tpuframe_torch.resilience",
              "tpuframe_torch.resilience.policy",
              "tpuframe_torch.resilience.faults",
              "tpuframe_torch.resilience.preempt", "tpuframe_torch.obs",
              "tpuframe_torch.obs.events", "tpuframe_torch.data.gcs"}
# The Horovod slice's modules.
HVD_SLICE = {"tpuframe_torch.parallel.bootstrap",
             "tpuframe_torch.parallel.hvd", "tpuframe_torch.launch",
             "tpuframe_torch.launch.launcher"}
# The stall watchdog and the serving fleet's modules.
FLEET_SLICE = {"tpuframe_torch.obs.heartbeat", "tpuframe_torch.obs.tracing",
               "tpuframe_torch.obs.exporter", "tpuframe_torch.obs.slo",
               "tpuframe_torch.obs.goodput", "tpuframe_torch.serve.replica",
               "tpuframe_torch.serve.router"}


def test_port_and_chip_smoke_import_without_jax():
    proc = subprocess.run([sys.executable, "-c", CODE], cwd=REPO,
                          env={**os.environ, "PYTHONPATH": REPO},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    names = set(proc.stdout.split())
    # the first slice's 14 modules (_build, _device, three subpackages and
    # their modules, the serving CLI) and every later slice's
    assert len(names) >= 14
    assert CKPT_SLICE <= names, CKPT_SLICE - names
    assert HVD_SLICE <= names, HVD_SLICE - names
    assert FLEET_SLICE <= names, FLEET_SLICE - names
