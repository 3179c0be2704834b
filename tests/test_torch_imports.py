"""dfmdock_tpu_torch and chip_smoke.py import neither JAX nor the JAX package:
every module is imported in a fresh interpreter whose import system refuses
both.  The modules of the PDB/ESM inputs, of training, of multi-GPU runs
and of the remainder (TM scores, frames, external corpora, logging,
Lightning checkpoints) are named, so a module that went missing from the
walk fails here too."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GUARD = r"""
import importlib, importlib.util, pkgutil, sys

class Refuse:
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "dfmdock_tpu"):
            raise ImportError(f"forbidden import: {name}")
        return None

sys.meta_path.insert(0, Refuse())
import dfmdock_tpu_torch
names = [m.name for m in pkgutil.walk_packages(dfmdock_tpu_torch.__path__, "dfmdock_tpu_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
assert not any(m.split(".")[0] in ("jax", "dfmdock_tpu") for m in sys.modules)
named = {"data.pdb_io", "data.esm", "data.crop", "models.esm2", "train.losses",
         "train.dfmdock_losses", "train.pool", "train.trainer", "cli.train",
         "parallel.world", "parallel.mesh", "parallel.dryrun", "eval.tm", "features.frames",
         "data.external", "utils.logging", "utils.torch_convert"}
assert {"dfmdock_tpu_torch." + n for n in named} <= set(names), sorted(names)
print(len(names))
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    r = subprocess.run([sys.executable, "-c", GUARD], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 48  # every module was walked
