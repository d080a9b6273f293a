"""Device facts: the peaks table refuses devices it does not know, the
compile cache sits where JAX_COMPILATION_CACHE_DIR says or at a fixed path
in the checkout, and chip_smoke.py refuses to run without a GPU."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from fiode_tpu.utils import device

REPO = Path(__file__).resolve().parents[1]


class TestPeaks:
    def test_h100_entry(self):
        pk = device.peaks("NVIDIA H100 80GB HBM3")
        assert pk["bf16_flops_per_s"] == 989e12
        assert pk["tf32_flops_per_s"] == 495e12
        assert pk["fp32_flops_per_s"] == 67e12
        assert pk["hbm_bytes_per_s"] == 3.35e12

    @pytest.mark.parametrize("kind", ["cpu", "NVIDIA L4", "NVIDIA A100"])
    def test_unknown_device_is_an_error(self, kind):
        with pytest.raises(KeyError, match="no published peaks"):
            device.peaks(kind)


class TestCompileCache:
    @pytest.fixture
    def restore_cache_dir(self):
        before = jax.config.jax_compilation_cache_dir
        yield
        jax.config.update("jax_compilation_cache_dir", before)

    def test_env_var_wins_and_nothing_is_set(self, monkeypatch, tmp_path,
                                             restore_cache_dir):
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        jax.config.update("jax_compilation_cache_dir", None)
        assert device.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir is None

    def test_fixed_path_in_checkout(self, monkeypatch, restore_cache_dir):
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        path = device.enable_compile_cache()
        assert path == str(REPO / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        # the same path on every call: no temporary or per-process part
        assert device.enable_compile_cache() == path


class TestChipSmokeRefusesCpu:
    def _run(self, cwd, env_extra):
        env = dict(os.environ, **env_extra)
        return subprocess.run(
            [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
            capture_output=True, text=True, timeout=300,
        )

    @staticmethod
    def _printed_result(stdout):
        for line in stdout.splitlines():
            try:
                if "ok" in json.loads(line):
                    return True
            except ValueError:
                pass
        return False

    def test_cpu_only_run_fails(self):
        r = self._run(REPO, {"JAX_PLATFORMS": "cpu"})
        assert r.returncode != 0
        assert "needs a GPU" in r.stderr
        assert not self._printed_result(r.stdout)

    def test_script_alone_fails(self, tmp_path):
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        r = self._run(tmp_path, {"JAX_PLATFORMS": "cpu"})
        assert r.returncode != 0
        assert not self._printed_result(r.stdout)
