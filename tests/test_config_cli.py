"""Config composition + CLI end-to-end: the reference's hydra surface
(defaults lists, group@path multi-instance entries, interpolation, CLI
overrides) and a tiny full train run through the composed config."""
import json
from pathlib import Path

import numpy as np
import pytest

from fiode_tpu.utils.config import ConfigStore, compose, parse_overrides

REPO = Path(__file__).resolve().parents[1]


class TestCompose:
    def test_cifar_train_composition(self):
        cfg = compose(
            "cifar_train.yaml", [], str(REPO / "configs/classification")
        )
        assert cfg["dataset"]["name"] == "CIFAR10"
        assert cfg["module"]["dynamics"]["alpha_1"] == 100.0
        assert cfg["module"]["dynamics"]["scale_nominal"] is True
        # interpolation resolved
        assert cfg["module"]["dynamics"]["n_hidden"] == 10
        assert cfg["module"]["lya_cand"]["on_simplex"] is True
        # multi-instance callbacks present and ordered
        assert cfg["_sampler_callback_dict"]["s1"]["target"] == "UniformSimplexSampling"
        assert cfg["_sch_callback_dict"]["v1"]["rate"] == -0.02

    def test_overrides(self):
        cfg = compose(
            "cifar_train.yaml",
            ["++module.lr=1e-4", "module.dynamics.kappa=3.5", "++seed=7"],
            str(REPO / "configs/classification"),
        )
        assert cfg["module"]["lr"] == 1e-4
        assert cfg["module"]["dynamics"]["kappa"] == 3.5
        assert cfg["seed"] == 7

    def test_add_group_override(self):
        cfg = compose(
            "cifar_train.yaml",
            ["+module/lya_cand@module.lya_cand=OnemEtay"],
            str(REPO / "configs/classification"),
        )
        assert cfg["module"]["lya_cand"]["target"] == "OnemEtay"

    def test_certify_config(self):
        cfg = compose(
            "cifar_certify.yaml", ["++T=20", "++end_ind=50"],
            str(REPO / "configs/certify"),
        )
        assert cfg["T"] == 20
        assert cfg["end_ind"] == 50
        assert cfg["module"]["dynamics"]["scale_nominal"] is False

    def test_unknown_group_raises(self):
        with pytest.raises(KeyError):
            ConfigStore.get("module/dynamics", "NoSuchThing")


class TestExperimentBuild:
    def test_build_and_tiny_train(self, tmp_path):
        from fiode_tpu.experiment import build_trainer, run_train

        cfg = compose(
            "mnist_train.yaml",
            [
                "++batch_size=32",
                "++synthetic_size=512",
                "++val_batch_size=64",
                "++module.h_sample_size=8",
                "++module.max_epochs=1",
                # tiny backbone so the CPU test stays fast
                "+module/init_fun/param_map@module.init_fun.param_map=TinyMLP",
                "++module.init_fun.param_map.out_dim=10",
                "++module.dynamics.mlp_size=32",
                "++data_root=" + str(tmp_path / "none"),
            ],
            str(REPO / "configs/classification"),
        )
        params, test = run_train(cfg, run_dir=str(tmp_path / "run"), epochs=1)
        assert "validation_error" in test
        recs = [
            json.loads(l) for l in open(tmp_path / "run" / "metrics.jsonl")
        ]
        assert any("training_loss" in r for r in recs)
        assert (tmp_path / "run" / "ckpt").exists()


class TestYamlSubset:
    """configs/ are read by the standard library alone."""

    def test_parse_yaml_constructs(self):
        from fiode_tpu.utils.config import parse_yaml

        text = (
            "# comment\n"
            "defaults:\n"
            "  - {module: Lyapunov}\n"
            "  - {\"\": default}\n"
            "a:\n"
            "  b: 1.0e-3   # trailing comment\n"
            "  c: [1.0, 2]\n"
            "  d: {rate: -0.02, clamp: min}\n"
            "  e:\n"
            "    f: true\n"
            "norm: \"2\"\n"
            "g: null\n"
            "h: text with spaces\n"
        )
        assert parse_yaml(text) == {
            "defaults": [{"module": "Lyapunov"}, {"": "default"}],
            "a": {"b": 1e-3, "c": [1.0, 2],
                  "d": {"rate": -0.02, "clamp": "min"}, "e": {"f": True}},
            "norm": "2", "g": None, "h": "text with spaces",
        }

    def test_override_values(self):
        _, sets = parse_overrides(
            ["a=1e-4", "b=[2,2]", "c=true", "d=TinyMLP", "e='x y'", "f=3"]
        )
        assert sets == [("a", 1e-4), ("b", [2, 2]), ("c", True),
                        ("d", "TinyMLP"), ("e", "x y"), ("f", 3)]

    @pytest.mark.parametrize("name,kind", [
        ("cifar_train.yaml", "classification"),
        ("mnist_train.yaml", "classification"),
        ("cifar_certify.yaml", "certify"),
        ("mnist_certify.yaml", "certify"),
    ])
    def test_compose_without_pyyaml(self, name, kind):
        import subprocess
        import sys

        code = (
            "import sys; sys.modules['yaml'] = None\n"
            "from fiode_tpu.utils.config import compose\n"
            f"cfg = compose({name!r}, ['++T=6'], {str(REPO / 'configs' / kind)!r})\n"
            "assert cfg['dataset']['N_CLASSES'] == 10 and cfg['T'] == 6\n"
            "assert cfg['module']['dynamics']['mlp_size'] == 128\n"
        )
        r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr
