"""The main path needs nothing beyond JAX, numpy, scipy, optax and the
standard library: every CLI subcommand's modules import with flax, PyYAML
and orbax blocked."""
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

# the modules each subcommand of fiode_tpu/cli.py imports
SUBCOMMANDS = {
    "train": ["fiode_tpu.experiment", "fiode_tpu.parallel.multihost"],
    "sample-grid": ["fiode_tpu.experiment", "fiode_tpu.verify.grid"],
    "certify-crown": ["fiode_tpu.experiment", "fiode_tpu.verify.certify",
                      "fiode_tpu.verify.refine"],
    "certify-lipschitz": ["fiode_tpu.experiment",
                          "fiode_tpu.verify.refine_lips"],
    "eval-autoattack": ["fiode_tpu.experiment",
                        "fiode_tpu.attacks.autoattack"],
    "summarize-stream": ["fiode_tpu.verify.certify"],
    "data-check": ["fiode_tpu.train.data"],
    "segway-train": ["fiode_tpu.control.train_segway"],
    "segway-certify": ["fiode_tpu.control.certify_segway"],
}


@pytest.mark.parametrize("cmd", sorted(SUBCOMMANDS))
def test_subcommand_imports_without_optional_packages(cmd):
    mods = ["fiode_tpu.cli", "fiode_tpu.utils.checkpoint",
            "fiode_tpu.utils.config", *SUBCOMMANDS[cmd]]
    code = (
        "import sys\n"
        "for m in ('flax', 'yaml', 'orbax'):\n"
        "    sys.modules[m] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('flax', 'yaml', 'orbax') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120,
                       env={"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stderr
