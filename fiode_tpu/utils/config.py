"""Config system: grouped defaults, YAML composition, CLI overrides,
interpolation — the capability surface of the reference's hydra/omegaconf
stack (ExpConfig.py:13-408, configs/*.yaml) without the hydra dependency.

  * a registry of config *groups* (dataset, module, module/dynamics,
    module/sampler, module/sampler_scheduler, module/lya_cand,
    module/init_fun/param_map, module/output) holding named dict nodes;
  * YAML files with a ``defaults:`` list composed in order (including the
    reference's multi-instance ``group@path.key: Option`` syntax for
    sampler/scheduler lists), read by ``parse_yaml``: the subset of YAML
    that configs/ uses (block mappings and sequences, flow ``{}``/``[]``
    collections, plain and quoted scalars, comments) on the standard
    library alone;
  * CLI overrides ``key.path=value`` / ``+group=option`` / ``++key=value``
    (hydra-compatible spelling);
  * ``${a.b.c}`` interpolation resolved after composition (the role of
    omegaconf II()).
"""
from __future__ import annotations

import copy
import re
from pathlib import Path
from typing import Dict, List, Optional

__all__ = [
    "ConfigStore", "compose", "parse_overrides", "parse_yaml", "resolve",
]


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


class ConfigStore:
    _groups: Dict[str, Dict[str, dict]] = {}

    @classmethod
    def store(cls, group: str, name: str, node: dict):
        cls._groups.setdefault(group, {})[name] = node

    @classmethod
    def get(cls, group: str, name: str) -> dict:
        try:
            return copy.deepcopy(cls._groups[group][name])
        except KeyError:
            raise KeyError(
                f"no config node {name!r} in group {group!r}; "
                f"available: {sorted(cls._groups.get(group, {}))}"
            ) from None


def _register_defaults():
    cs = ConfigStore
    # datasets (ExpConfig.py:22-58)
    for name, (ch, size, ncls, mu, std) in {
        "MNIST": (1, 28, 10, [0.1307], [0.3081]),
        "FashionMNIST": (1, 28, 10, [0.5], [0.5]),
        "CIFAR10": (3, 32, 10, [0.485, 0.456, 0.406], [0.225, 0.225, 0.225]),
        "CIFAR3": (3, 32, 3, [0.485, 0.456, 0.406], [0.225, 0.225, 0.225]),
    }.items():
        cs.store("dataset", name, {
            "name": name, "IN_CHANNEL": ch, "N_CLASSES": ncls,
            "IMG_SIZE": [size, size], "MU": mu, "STD": std,
        })
    # dynamics (ExpConfig.py:80-97)
    cs.store("module/dynamics", "OrthoClassDynProjectSimplexLips", {
        "target": "SimplexDynamics",
        "n_hidden": "${dataset.N_CLASSES}", "activation": "ReLU",
        "dropout": 0.5, "mlp_size": 128, "kappa": 1.0, "kappa_length": 0,
        "alpha_1": 100.0, "alpha_2": 20.0, "sigma_1": 0.02,
        "scale_nominal": False, "x_dim": 10, "cayley": True,
    })
    # backbones / param maps (ExpConfig.py:107-162)
    for name in [
        "ORTHO_KWLarge_Concat", "ORTHO_KWLargeMNIST_Concat",
        "ORTHO_KWLarge_Concat_test", "ORTHO_KWLargeMNIST_Concat_test",
        "CIFAR_4C3F", "CIFAR_4C3F_nolips", "CIFAR_6C2F", "TinyMLP",
    ]:
        cs.store("module/init_fun/param_map", name, {
            "target": name, "mu": "${dataset.MU}", "std": "${dataset.STD}",
            "out_dim": 128, "act": "GroupSort",
        })
    # init funs (ExpConfig.py:70-77)
    for name in ["DefaultInitFun", "UniformInitFun"]:
        cs.store("module/init_fun", name, {
            "target": name, "h_dims": ["${dataset.N_CLASSES}"],
            "param_map": None,
        })
    # output (ExpConfig.py:61-67)
    cs.store("module/output", "Output", {"target": "default"})
    cs.store("module/output", "FirstNOutput",
             {"target": "first_n", "out_size": "${dataset.N_CLASSES}"})
    # lyapunov candidates (ExpConfig.py:165-196)
    for name in ["MSELoss", "CompositeDynCrossEntropy", "DynCrossEntropy",
                 "OnemEtay", "DecisionBoundary"]:
        cs.store("module/lya_cand", name, {
            "target": name, "on_simplex": "${module.simplex}",
            "log_mode": False, "num_class": "${dataset.N_CLASSES}",
        })
    # samplers (ExpConfig.py:286-325)
    for name in ["UniformSimplexSampling", "BandSimplexSampling",
                 "ProjectedBiasedHyperSphereSampling",
                 "ProjectedHyperCubeSampling", "CorrectConeSampling",
                 "DecisionBoundarySampling", "TrajectorySampler"]:
        cs.store("module/sampler", name, {"target": name})
    cs.store("module/sampler", "CompositeSampler", {"target": "CompositeSampler"})
    # sampler schedulers (ExpConfig.py:258-284)
    cs.store("module/sampler_scheduler", "LinearScheduler", {
        "target": "LinearScheduler", "rate": 1.0, "bias": 0.0,
        "clamp": "min", "clamp_val": 0.0, "start": 0,
    })
    cs.store("module/sampler_scheduler", "ConstantScheduler",
             {"target": "ConstantScheduler", "constant": 1.0})
    cs.store("module/sampler_scheduler", "SwitchScheduler",
             {"target": "SwitchScheduler", "start": 0.0, "end": 1.0,
              "trigger": 1.0})
    cs.store("module/sampler_scheduler", "CompositeSamplerScheduler",
             {"target": "CompositeSamplerScheduler",
              "scheduler_weights": [1.0, 1.0]})
    # modules (ExpConfig.py:198-256)
    general = {
        "decay_epochs": [30, 60, 90], "weight_decay": 0.0, "lr": 1e-3,
        "opt_name": "SGD", "momentum": 0.9, "beta1": 0.9, "beta2": 0.999,
        "scheduler_name": "cos_anneal", "max_epochs": 200, "warmup": 20,
        "adv_train": False, "eps": 0.5, "norm": "L2", "act": "relu",
        "fix_backbone": False, "val_adv": True,
    }
    ode = dict(general, **{
        "t_max": 1.0, "train_ode_solver": "dopri5", "train_ode_tol": 1e-7,
        "val_ode_solver": "dopri5", "val_ode_tol": 1e-7, "simplex": False,
        "n_output": "${dataset.N_CLASSES}",
    })
    cs.store("module", "ODEModule", dict(ode, target="ODELearning"))
    cs.store("module", "Lyapunov", dict(ode, **{
        "target": "LyapunovLearning", "order": 1, "h_sample_size": 128,
        "h_dist_lim": 30.0, "barrier_loss": False, "lips_train": False,
        "train_ode": False, "train_ode_epoch": 50,
        "relax_exp_stable": False, "scaleLeps": 3.0,
        "epoch_off_scale": 10, "lips_warmup": 0,
    }))
    # experiment roots (ExpConfig.py:327-362)
    cs.store("", "default", {
        "batch_size": 32, "val_batch_size": 32, "data_root": "data",
        "savedir": "run_data", "gpus": 1, "seed": 0, "disable_logs": False,
    })
    cs.store("", "certify", {
        "batch_size": 32, "val_batch_size": 32, "data_root": "data",
        "savedir": "run_data", "gpus": 1, "seed": 0, "disable_logs": False,
        "model_file": None, "norm": "2", "eps": 0.141, "kappa": 0.2,
        "T": 40, "batches": 10, "load_grid": False, "grid_name": "grid.pt",
        "start_ind": 0, "end_ind": 10000, "download": False,
    })


_register_defaults()


# ---------------------------------------------------------------------------
# composition
# ---------------------------------------------------------------------------


def _set_path(cfg: dict, path: str, value):
    keys = path.split(".")
    node = cfg
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def _get_path(cfg: dict, path: str):
    node = cfg
    for k in path.split("."):
        if isinstance(node, list):
            node = node[int(k)]
        else:
            node = node[k]
    return node


def _deep_merge(dst: dict, src: dict):
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_merge(dst[k], v)
        else:
            dst[k] = copy.deepcopy(v)


def _apply_default(cfg: dict, entry):
    """One ``defaults:`` list entry: {'group': 'Option'} or
    {'group@target.path': 'Option'} or the literal strings used as roots."""
    if isinstance(entry, str):
        entry = {"": entry}
    (key, option), = entry.items()
    if key == "_self_" or option is None:
        return
    if "@" in key:
        group, target = key.split("@", 1)
    else:
        group, target = key, key.replace("/", ".")
    node = ConfigStore.get(group, option)
    if target == "":
        _deep_merge(cfg, node)
    else:
        cur = cfg
        keys = target.split(".")
        for k in keys[:-1]:
            cur = cur.setdefault(k, {})
        if isinstance(cur.get(keys[-1]), dict):
            _deep_merge(cur[keys[-1]], node)
        else:
            cur[keys[-1]] = node


_INTERP = re.compile(r"^\$\{([^}]+)\}$")


def resolve(cfg: dict, root: Optional[dict] = None):
    """Resolve ${a.b.c} interpolations in place (repeated to fixpoint)."""
    root = root if root is not None else cfg

    def walk(node):
        changed = False
        it = node.items() if isinstance(node, dict) else enumerate(node)
        for k, v in it:
            if isinstance(v, str):
                m = _INTERP.match(v)
                if m:
                    try:
                        node[k] = _get_path(root, m.group(1))
                        changed = True
                    except (KeyError, TypeError):
                        pass
            elif isinstance(v, (dict, list)):
                changed |= walk(v)
        return changed

    for _ in range(10):
        if not walk(cfg):
            break
    return cfg


# ---------------------------------------------------------------------------
# YAML subset
# ---------------------------------------------------------------------------

_INT = re.compile(r"^[+-]?\d+$")
_FLOAT = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?$")
_CONSTANTS = {"true": True, "True": True, "false": False, "False": False,
              "null": None, "Null": None, "~": None, "": None}


def _scalar(tok: str):
    """A plain or quoted YAML scalar.  '1e-4' reads as a float, as CLI
    users expect (YAML 1.1 would leave it a string)."""
    tok = tok.strip()
    if len(tok) >= 2 and tok[0] == tok[-1] and tok[0] in "'\"":
        return tok[1:-1]
    if tok in _CONSTANTS:
        return _CONSTANTS[tok]
    if _INT.match(tok):
        return int(tok)
    if _FLOAT.match(tok):
        return float(tok)
    return tok


def _flow(text: str, i: int = 0):
    """Parse one flow value starting at ``text[i]``; returns (value, end)."""
    while i < len(text) and text[i] == " ":
        i += 1
    if i < len(text) and text[i] in "[{":
        close = "]" if text[i] == "[" else "}"
        items, i = [], i + 1
        while True:
            while i < len(text) and text[i] == " ":
                i += 1
            if i >= len(text):
                raise ValueError(f"unclosed {text[i - 1]!r} in {text!r}")
            if text[i] == close:
                i += 1
                break
            if close == "}":
                key, i = _flow(text, i)
                if i >= len(text) or text[i] != ":":
                    raise ValueError(f"expected ':' in {text!r}")
                val, i = _flow(text, i + 1)
                items.append((key, val))
            else:
                val, i = _flow(text, i)
                items.append(val)
            while i < len(text) and text[i] == " ":
                i += 1
            if i < len(text) and text[i] == ",":
                i += 1
        return (dict(items) if close == "}" else items), i
    if i < len(text) and text[i] in "'\"":
        j = text.index(text[i], i + 1)
        return text[i + 1 : j], j + 1
    j = i
    while j < len(text) and text[j] not in ",]}" and not (
        text[j] == ":" and (j + 1 == len(text) or text[j + 1] == " ")
    ):
        j += 1
    return _scalar(text[i:j]), j


def _parse_value(text: str):
    val, end = _flow(text)
    if text[end:].strip():
        raise ValueError(f"trailing characters in YAML value {text!r}")
    return val


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] == " "):
            return line[:i].rstrip()
    return line.rstrip()


def parse_yaml(text: str):
    """Parse the YAML subset the config files use: nested block mappings
    (``key: value`` / ``key:`` + indented block), block sequences
    (``- value``), flow collections, scalars and ``#`` comments."""
    lines = [(len(l) - len(l.lstrip(" ")), l.strip())
             for l in map(_strip_comment, text.splitlines()) if l.strip()]

    def block(pos, indent):
        if lines[pos][1].startswith("- ") or lines[pos][1] == "-":
            out = []
            while pos < len(lines) and lines[pos][0] == indent \
                    and lines[pos][1].startswith("-"):
                out.append(_parse_value(lines[pos][1][1:]))
                pos += 1
            return out, pos
        out = {}
        while pos < len(lines) and lines[pos][0] == indent:
            key, rest = _flow(lines[pos][1])
            if not lines[pos][1][rest:].startswith(":"):
                raise ValueError(f"expected 'key: value': {lines[pos][1]!r}")
            rest = lines[pos][1][rest + 1 :].strip()
            pos += 1
            if rest:
                out[key] = _parse_value(rest)
            elif pos < len(lines) and lines[pos][0] > indent:
                out[key], pos = block(pos, lines[pos][0])
            else:
                out[key] = None
        return out, pos

    if not lines:
        return None
    out, pos = block(0, lines[0][0])
    if pos != len(lines):
        raise ValueError(f"bad indentation at {lines[pos][1]!r}")
    return out


def parse_overrides(args: List[str]):
    """hydra-style: 'a.b=v' (set), '+group=Option' (add default),
    '++a.b=v' (force set).  Values parsed as YAML flow values."""
    sets, adds = [], []
    for a in args:
        if "=" not in a:
            raise ValueError(f"override {a!r} must be key=value")
        k, v = a.split("=", 1)
        if k.startswith("++"):
            sets.append((k[2:], _parse_value(v)))
        elif k.startswith("+"):
            adds.append((k[1:], v))
        else:
            sets.append((k, _parse_value(v)))
    return adds, sets


def compose(
    config_file: Optional[str] = None,
    overrides: Optional[List[str]] = None,
    config_dir: Optional[str] = None,
) -> dict:
    """Compose a config from a YAML file's defaults + CLI overrides."""
    cfg: dict = {}
    raw = {}
    if config_file:
        path = Path(config_dir or ".") / config_file
        if not path.suffix:
            path = path.with_suffix(".yaml")
        raw = parse_yaml(path.read_text()) or {}
    adds, sets = parse_overrides(overrides or [])
    defaults = list(raw.pop("defaults", []))
    for group, option in adds:
        defaults.append({group: option})
    for entry in defaults:
        _apply_default(cfg, entry)
    _deep_merge(cfg, raw)  # file body overrides defaults
    for k, v in sets:
        _set_path(cfg, k, v)
    return resolve(cfg)
