"""Run the train -> certify -> attack path once on an NVIDIA GPU and check it.

    python chip_smoke.py              # one card: the six phases below
    python chip_smoke.py --cards 4    # four cards: the data-parallel train
                                      # step and the 2x2 certification mesh

Phases (one card), each printing one JSON line:
  1. forward_solve  the flagship (KWLarge Cayley backbone, 10->128->128->10
                    simplex dynamics, dopri5 at rtol=atol=1e-3) through
                    ``model.predict`` in ``mode="scan"`` and ``"while"`` at
                    the reference val batch of 512;
  2. train          three ``LyapunovTrainer`` steps at batch 128 x 256
                    h-samples on synthetic CIFAR;
  3. certify        the committed checkpoint restored the way
                    ``certify-crown --run-dir`` restores it, then
                    ``Certifier.certify(method="crown")`` over the full T=40
                    grid for test images 4-7, against the committed record;
  4. attack         one APGD-CE iteration through the solve at t_max=0.1;
  5. fused_rhs      the Triton RHS kernel against ``rhs_reference`` and the
                    flagship forward solve at B=32768 with and without it;
  6. gpu_tests      the tests marked ``gpu``, in this process.

Every phase compares with a reference: the same code on
``jax.devices("cpu")`` in this process at ``highest`` matmul precision, on
a slice small enough for the CPU.  The GPU side runs at the backend default
(float32 matmuls in TF32 on an H100) and, where stated, also at
``highest``; each line names both precisions, the largest error and its
tolerance.  The last line is ``{"ok": true, "device": {...}}``.  Without a
GPU the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
CKPT_RUN = REPO / "run_data" / "certified_full"

# the users' sizes: the reference val batch, the training protocol
# (configs/classification/cifar_train.yaml), the attack batch, the bench's
# solve batch, one 1M-cell certification chunk, the default BaB frontier
SOLVE_BATCH = 512
MAX_STEPS = 64  # the trip budget experiment.build_model gives CLI users
TRAIN_BATCH, H_SAMPLES = 128, 256
ATTACK_BATCH = 64
RHS_BATCH = 32768
CERT_IMAGES = [4, 5, 6, 7]
CHUNK_CELLS = 1 << 20
BAB_CAP = 1 << 25

# TF32 keeps a 10-bit mantissa (~5e-4 relative per product): through the
# backbone's seven layers and the adaptive solve at rtol=atol=1e-3, where
# a perturbed error ratio can flip an accept/reject, class probabilities
# move by up to ~1e-2.
TOL_TF32_PROBS = 2e-2
# both sides IEEE float32; they differ only in summation order and
# transcendental implementations
TOL_F32_PROBS = 1e-4
# relative errors of a scalar loss / gradient norm at TF32 vs float32
TOL_TF32_REL = 2e-2
TOL_F32_REL = 1e-4
# certification is pinned to float32 on both sides.  CROWN picks each
# unstable neuron's lower line by comparing u with |l| and the QP interval
# bisection branches on the sign of a sum, so at near-ties a last-bit
# difference between the backends switches to another sound bound: the
# 1M-cell chunk's worst bounds differed by 7.2e-5 with everything pinned,
# and by 3.7e-4 while TF32 leaked into the dense twin.  2e-4 separates them.
TOL_CERT_BOUND = 2e-4
# an image whose certified flag differs from the committed record passes
# only if its worst cell lies this close to the decision threshold 0
MARGIN_TOL = 1e-3


def _emit(line: dict) -> None:
    """Print a phase's JSON line, then fail if any of its checks failed."""
    print(json.dumps(line), flush=True)
    bad = [k for k, v in line.items() if isinstance(v, dict)
           and v.get("ok") is False]
    if bad:
        raise AssertionError(f"{line['phase']}: beyond tolerance: {bad}")


def _log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def _peak_bytes(dev) -> int:
    return int(dev.memory_stats()["peak_bytes_in_use"])


def _compile(fn, *args):
    """AOT-compile ``fn`` for ``args``; returns (compiled, seconds)."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    return compiled, time.perf_counter() - t0


def _run(compiled, *args, repeats: int = 1):
    """Call ``compiled``; returns (output, median seconds over repeats)."""
    import jax

    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = jax.block_until_ready(compiled(*args))
        times.append(time.perf_counter() - t0)
    return out, float(np.median(times))


def _max_err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def _rel_err(a, b) -> float:
    b = np.asarray(b, np.float64)
    return _max_err(a, b) / max(float(np.max(np.abs(b))), 1e-30)


def _check(err: float, tol: float) -> dict:
    return {"err": err, "tol": tol, "ok": bool(err <= tol)}  # NaN fails


def _synthetic_cifar(seed: int):
    from fiode_tpu.train.data import load_dataset

    return load_dataset("CIFAR10", data_root=str(REPO / "no-data"),
                        seed=seed, synthetic_size=4096)


def _flagship(**kw):
    from __graft_entry__ import _flagship as make

    return dataclasses.replace(make(), **kw)


def _train_cfg(batch_size):
    from fiode_tpu.train.trainer import TrainConfig

    # the reference CIFAR protocol (configs/classification/cifar_train.yaml)
    return TrainConfig(opt_name="Adam", lr=5e-3, batch_size=batch_size,
                       val_batch_size=256, h_sample_size=H_SAMPLES,
                       h_dist_lim=15.0, max_epochs=300, warmup=-1)


# ---------------------------------------------------------------------------
# one card
# ---------------------------------------------------------------------------


def phase_forward_solve(gpu, cpu, seed):
    import jax
    import jax.numpy as jnp

    ds = _synthetic_cifar(seed)
    model = _flagship(max_steps=MAX_STEPS)
    x = np.asarray(ds.test_x[:SOLVE_BATCH])
    params = jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.asarray(x[:8]))
    xg = jax.device_put(x, gpu)

    out = {"phase": "forward_solve", "batch": SOLVE_BATCH,
           "precision": {"gpu": ["default", "highest"], "cpu": "highest"}}
    with jax.default_device(cpu), jax.default_matmul_precision("highest"):
        pc, xc = jax.device_put((params, x), cpu)
        ref_fn, _ = _compile(lambda p, x: model.predict(p, x, mode="while"),
                             pc, xc)
        ref, out["cpu_seconds"] = _run(ref_fn, pc, xc)
    _log("forward_solve: CPU reference done")
    compile_s, seconds = {}, {}
    for prec, tol in (("default", TOL_TF32_PROBS), ("highest", TOL_F32_PROBS)):
        with jax.default_matmul_precision(prec):
            for mode in ("scan", "while"):
                fn, compile_s[f"{mode}_{prec}"] = _compile(
                    lambda p, x, m=mode: model.predict(p, x, mode=m),
                    params, xg)
                probs, seconds[f"{mode}_{prec}"] = _run(fn, params, xg,
                                                        repeats=3)
                out[f"{mode}_{prec}"] = _check(_max_err(probs, ref), tol)
                _log(f"forward_solve: {mode}@{prec} done")
    with jax.default_matmul_precision("default"):
        feat_fn, compile_s["backbone"] = _compile(model.features, params, xg)
        _, seconds["backbone"] = _run(feat_fn, params, xg, repeats=3)
    out["backbone_share"] = {
        mode: seconds["backbone"] / seconds[f"{mode}_default"]
        for mode in ("scan", "while")}
    out.update(seconds=seconds, compile_seconds=compile_s,
               peak_bytes_in_use=_peak_bytes(gpu))
    _emit(out)
    return model, params


def phase_train(gpu, cpu, seed):
    import jax
    import jax.numpy as jnp
    import tempfile

    from fiode_tpu.parallel.mesh import make_mesh, replicate, shard_batch
    from fiode_tpu.train.trainer import LyapunovTrainer

    ds = _synthetic_cifar(seed)
    model = _flagship()
    B = TRAIN_BATCH
    out = {"phase": "train", "batch": B, "h_sample_size": H_SAMPLES,
           "precision": {"gpu": ["default", "highest"], "cpu": "highest"}}
    with tempfile.TemporaryDirectory() as td:
        mesh = make_mesh(1)
        tr = LyapunovTrainer(model, _train_cfg(B), ds, run_dir=td, mesh=mesh)
        x = jnp.asarray(ds.train_x[:B])
        params = replicate(mesh, jax.jit(model.init)(
            jax.random.PRNGKey(seed), x[:8]))
        opt_state = replicate(mesh, tr.main_tx.init(params))
        mixer = jnp.asarray([0.5, 0.5])
        key = jax.random.PRNGKey(seed + 1)

        # the objective on an 8-image slice (x 256 h-samples), GPU vs CPU
        k0 = jax.random.PRNGKey(seed + 2)
        loss_args = (ds.train_x[:8], ds.train_y[:8], k0, 0, mixer, 2.0)
        grad_fn = jax.value_and_grad(
            lambda p, x, y, k, s, m, kap: tr.loss_fn(
                p, x, y, k, s, m, kap, True, 0.0), has_aux=True)

        def loss_and_gnorm(p, *a):
            (loss, _), g = grad_fn(p, *a)
            return loss, jnp.sqrt(sum(jnp.sum(v * v) for v in
                                      jax.tree_util.tree_leaves(g)))

        with jax.default_device(cpu), jax.default_matmul_precision("highest"):
            args_c = jax.device_put((params, *loss_args), cpu)
            fn, _ = _compile(loss_and_gnorm, *args_c)
            (loss_c, gn_c), out["cpu_seconds"] = _run(fn, *args_c)
        args_g = jax.device_put((params, *loss_args), gpu)
        for prec, tol in (("default", TOL_TF32_REL), ("highest", TOL_F32_REL)):
            with jax.default_matmul_precision(prec):
                fn, _ = _compile(loss_and_gnorm, *args_g)
                (loss_g, gn_g), _ = _run(fn, *args_g)
            out[f"loss_{prec}"] = _check(_rel_err(loss_g, loss_c), tol)
            out[f"grad_norm_{prec}"] = _check(_rel_err(gn_g, gn_c), tol)
        _log("train: loss and gradient checks done")

        # three optimizer steps at the protocol batch
        losses, times = [], []
        t0 = time.perf_counter()
        for step in range(3):
            bx, by = shard_batch(mesh, (
                jnp.asarray(ds.train_x[step * B:(step + 1) * B]),
                jnp.asarray(ds.train_y[step * B:(step + 1) * B])))
            key, k = jax.random.split(key)
            t1 = time.perf_counter()
            params, opt_state, _, loss, _ = tr._train_step(
                params, opt_state, None, k, bx, by, jnp.asarray(step), mixer,
                jnp.asarray(0.0), scale_nominal=True, use_warmup_tx=False)
            losses.append(float(loss))
            times.append(time.perf_counter() - t1)
        if not np.all(np.isfinite(losses)):
            raise AssertionError(f"train: non-finite loss {losses}")
    out.update(losses=losses, step_seconds=times[1:],
               first_step_seconds_with_compile=times[0],
               total_seconds=time.perf_counter() - t0,
               peak_bytes_in_use=_peak_bytes(gpu))
    _emit(out)


def _committed_flags(images):
    """Certified flags of test images in the committed streamed record."""
    with open(CKPT_RUN / "certify_stream_full.jsonl") as fh:
        first = json.loads(fh.readline())
    if not first["idx_from"] <= min(images) <= max(images) <= first["idx_to"]:
        raise ValueError(f"images {images} are not in the record's first "
                         "batch")
    certified = set(first["batch_certified_idx"])
    return np.asarray([i in certified for i in images])


def phase_certify(gpu, cpu, seed):
    import jax
    import jax.numpy as jnp

    from fiode_tpu.cli import CONFIG_DIRS
    from fiode_tpu.experiment import (_load_cfg_dataset, _restore_params,
                                      build_model)
    from fiode_tpu.utils.config import compose
    from fiode_tpu.verify.certify import Certifier
    from fiode_tpu.verify.grid import enumerate_decision_boundary
    from fiode_tpu.verify.refine import _kernels

    cfg = compose("cifar_certify.yaml", [], str(REPO / CONFIG_DIRS["certify"]))
    model = build_model(cfg)
    params = _restore_params(cfg, model, str(CKPT_RUN))
    ds = _load_cfg_dataset(cfg)
    idx = CERT_IMAGES
    images, labels = ds.test_x[idx], ds.test_y[idx]
    kw = dict(T=int(cfg["T"]), eps_input=float(cfg["eps"]),
              scale_nominal=bool(cfg["module"]["dynamics"]["scale_nominal"]))
    out = {"phase": "certify", "images": idx,
           "precision": {"gpu": "float32", "cpu": "float32"}}

    t0 = time.perf_counter()
    grid = enumerate_decision_boundary(10, kw["T"])
    out["grid_cells"], out["grid_seconds"] = len(grid), time.perf_counter() - t0
    _log(f"certify: grid of {len(grid)} cells")

    cert = Certifier(model, jax.device_put(params, gpu), grid=grid, **kw)
    t0 = time.perf_counter()
    res = cert.certify(images, labels, method="crown", early_exit=False)
    out["sweep_seconds_with_compile"] = time.perf_counter() - t0
    out["cells_per_sec"] = res.cells_per_sec
    want = _committed_flags(idx)
    out["certified"] = res.certified.tolist()
    out["committed"] = want.tolist()
    out["worst"] = res.worst.tolist()
    # a flag that differs from the record passes only within MARGIN_TOL
    differs = res.certified != want
    out["flags_vs_record"] = {
        "differs": np.asarray(idx)[differs].tolist(),
        "max_abs_margin_of_differing": float(
            np.max(np.abs(res.worst[differs]), initial=0.0)),
        "tol": MARGIN_TOL,
        "ok": bool(np.all(np.abs(res.worst[differs]) <= MARGIN_TOL)),
    }
    _log(f"certify: full sweep done, {res.cells_per_sec:.0f} cells/s")

    # worst-cell bounds over one 1M-cell chunk, GPU vs CPU
    chunk = grid[:CHUNK_CELLS]
    g_small = Certifier(model, jax.device_put(params, gpu), grid=chunk, **kw)
    r_g = g_small.certify(images, labels, method="crown", early_exit=False)
    with jax.default_device(cpu):
        c_small = Certifier(model, jax.device_put(params, cpu), grid=chunk,
                            **kw)
        t0 = time.perf_counter()
        r_c = c_small.certify(images, labels, method="crown",
                              early_exit=False)
        out["cpu_chunk_seconds"] = time.perf_counter() - t0
    out["chunk_worst"] = _check(_max_err(r_g.worst, r_c.worst),
                                TOL_CERT_BOUND)
    out["chunk_worst"].update(gpu=r_g.worst.tolist(), cpu=r_c.worst.tolist())
    _log("certify: 1M-cell chunk compared")

    # one device-resident BaB round at the default frontier capacity
    M = BAB_CAP
    make, _ = _kernels(cert)[3]
    shp = jax.ShapeDtypeStruct
    compiled = make(M).lower(
        shp((M, 10), jnp.float32), shp((M, 10), jnp.float32),
        shp((), jnp.int32), shp((cert.U.shape[0],), jnp.float32),
        shp((), jnp.int32)).compile()
    ma = compiled.memory_analysis()
    out["bab_round_memory"] = {
        k: int(getattr(ma, k)) for k in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "alias_size_in_bytes", "temp_size_in_bytes",
            "generated_code_size_in_bytes") if hasattr(ma, k)}
    print(f"bab round at device_cap={M}: {ma}", flush=True)
    out["peak_bytes_in_use"] = _peak_bytes(gpu)
    _emit(out)


def phase_attack(gpu, cpu, seed, model, params):
    import jax
    import jax.numpy as jnp

    from fiode_tpu.attacks.apgd import apgd_ce

    ds = _synthetic_cifar(seed)
    atk = dataclasses.replace(model, t_max=0.1)
    x, y = ds.test_x[:ATTACK_BATCH], ds.test_y[:ATTACK_BATCH]
    eps = 36 / 255
    out = {"phase": "attack", "batch": ATTACK_BATCH, "t_max": 0.1,
           "precision": {"gpu": ["default", "highest"], "cpu": "highest"}}

    def logits(p, x):
        return atk.output_fn(atk.solve(p, x, mode="scan").ys[-1])

    def input_grad(p, x, y):
        return jax.grad(lambda x: jnp.sum(
            -jax.nn.log_softmax(logits(p, x))[jnp.arange(y.shape[0]), y]))(x)

    with jax.default_device(cpu), jax.default_matmul_precision("highest"):
        args_c = jax.device_put((params, x, y), cpu)
        fn, _ = _compile(input_grad, *args_c)
        g_c, out["cpu_seconds"] = _run(fn, *args_c)
    args_g = jax.device_put((params, x, y), gpu)
    # The input gradient is piecewise smooth: the QP's active set and
    # GroupSort's pair order switch at ties, and a last-bit difference can
    # carry an image across a switch (on the CPU a 1e-5 input perturbation
    # moves one image of 64 by 23%, the median by 2e-6).  So the check is
    # on the median image's relative L2 error; the spread is reported.
    for prec, tol in (("default", 5 * TOL_TF32_REL), ("highest", 1e-4)):
        with jax.default_matmul_precision(prec):
            fn, _ = _compile(input_grad, *args_g)
            g_g, _ = _run(fn, *args_g)
        per_image = (
            np.linalg.norm((np.asarray(g_g) - np.asarray(g_c)).reshape(
                len(x), -1), axis=1)
            / np.linalg.norm(np.asarray(g_c).reshape(len(x), -1), axis=1))
        out[f"input_grad_{prec}"] = _check(float(np.median(per_image)), tol)
        out[f"input_grad_{prec}"].update(
            p90=float(np.percentile(per_image, 90)),
            max=float(per_image.max()))
    _log("attack: input gradient checks done")

    attack = lambda p, x, y, k: apgd_ce(
        lambda xa: logits(p, xa), x, y, k, eps=eps, norm="L2", n_iter=1)
    fn, compile_s = _compile(attack, *args_g, jax.random.PRNGKey(seed))
    (x_adv, success), seconds = _run(fn, *args_g, jax.random.PRNGKey(seed))
    dist = np.linalg.norm(
        np.asarray(x_adv - args_g[1]).reshape(len(x), -1), axis=1)
    if not (np.all(np.isfinite(np.asarray(x_adv))) and dist.max() <= eps + 1e-4):
        raise AssertionError(f"attack: adversarial outside the eps ball "
                             f"({dist.max()} > {eps})")
    out.update(apgd_seconds=seconds, apgd_compile_seconds=compile_s,
               max_l2_perturbation=float(dist.max()),
               success_rate=float(np.mean(np.asarray(success))),
               peak_bytes_in_use=_peak_bytes(gpu))
    _emit(out)


def phase_fused_rhs(gpu, cpu, seed):
    import jax
    import jax.numpy as jnp

    from fiode_tpu.ops.fused_rhs import (fused_rhs, pack_rhs_params,
                                         pad_width, rhs_reference)

    B, n, mlp = RHS_BATCH, 10, 128
    out = {"phase": "fused_rhs", "batch": B,
           "precision": {"gpu": ["default", "highest"],
                         "reference": "same precision, plain XLA"}}
    ks = jax.random.split(jax.random.PRNGKey(seed), 7)
    p = pack_rhs_params(0.3 * jax.random.normal(ks[0], (mlp, n)),
                        0.1 * jax.random.normal(ks[1], (mlp, mlp)),
                        0.1 * jax.random.normal(ks[2], (n, mlp)),
                        0.1 * jax.random.normal(ks[3], (mlp,)),
                        0.1 * jax.random.normal(ks[4], (n,)))
    h = jax.random.uniform(ks[5], (B, n))
    h = jnp.zeros((B, pad_width(n))).at[:, :n].set(h / h.sum(-1, keepdims=True))
    xc = 0.5 * jax.random.normal(ks[6], (B, mlp))
    consts = (n, 100.0, 0.02, 20.0, False, 30)
    # TF32 products round differently in the kernel's dot and in cuBLAS
    for prec, tol in (("default", 5e-3), ("highest", 1e-5)):
        with jax.default_matmul_precision(prec):
            kf, _ = _compile(lambda h, xc, p: fused_rhs(h, xc, p, *consts),
                             h, xc, p)
            rf, _ = _compile(lambda h, xc, p: rhs_reference(h, xc, p, *consts),
                             h, xc, p)
            got, tk = _run(kf, h, xc, p, repeats=20)
            want, tr = _run(rf, h, xc, p, repeats=20)
        out[f"rhs_{prec}"] = _check(_max_err(got, want), tol)
        out[f"rhs_{prec}"].update(kernel_seconds=tk, xla_seconds=tr)

    # the flagship forward solve at the bench's batch, kernel vs plain XLA,
    # timed in turns (plain, fused, fused, plain, ...)
    model = _flagship(max_steps=8)
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.uniform(0, 1, (B, 3, 32, 32)).astype(np.float32))
    params = jax.jit(model.init)(jax.random.PRNGKey(seed), x[:8])
    fns, ends = {}, {}
    for fused in (False, True):
        fns[fused], out[f"solve_compile_seconds_fused_{fused}"] = _compile(
            lambda p, x, f=fused: model.solve(p, x, mode="scan", fused=f),
            params, x)
        sol, _ = _run(fns[fused], params, x)
        ends[fused] = sol.ys[-1]
        out[f"solve_nfe_fused_{fused}"] = int(sol.nfe)
    times = {False: [], True: []}
    for fused in (False, True, True, False, False, True):
        times[fused].append(_run(fns[fused], params, x)[1])
    out["solve_seconds_xla"] = times[False]
    out["solve_seconds_kernel"] = times[True]
    # both solves run TF32 matmuls, rounded differently by the kernel's dot
    # and by cuBLAS: the same perturbation phase 1 bounds, checked on the
    # 99th-percentile sample (the max over 32768 samples moved between
    # 4.8e-3 and 1.6e-2 across two runs); the max is reported
    per_sample = np.max(np.abs(np.asarray(ends[True], np.float64)
                               - np.asarray(ends[False], np.float64)), axis=-1)
    out["solve_endpoint_diff"] = _check(float(np.percentile(per_sample, 99)),
                                        TOL_TF32_PROBS)
    out["solve_endpoint_diff"]["max"] = float(per_sample.max())
    out["peak_bytes_in_use"] = _peak_bytes(gpu)
    _emit(out)


def phase_gpu_tests(gpu):
    import pytest

    t0 = time.perf_counter()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:xdist", str(REPO / "tests")])
    if rc != 0:
        raise AssertionError(f"gpu_tests: pytest exit code {rc}")
    _emit({"phase": "gpu_tests", "pytest_exit": int(rc),
           "seconds": time.perf_counter() - t0,
           "peak_bytes_in_use": _peak_bytes(gpu)})


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------


def phase_data_parallel(devs, seed):
    import jax
    import jax.numpy as jnp
    import tempfile

    from fiode_tpu.parallel.mesh import make_mesh, replicate, shard_batch
    from fiode_tpu.train.trainer import LyapunovTrainer

    ds = _synthetic_cifar(seed)
    model = _flagship()
    B = TRAIN_BATCH
    out = {"phase": "data_parallel_train", "cards": len(devs), "batch": B,
           "h_sample_size": H_SAMPLES, "precision": "highest"}
    x, y = jnp.asarray(ds.train_x[:B]), jnp.asarray(ds.train_y[:B])
    mixer = jnp.asarray([0.5, 0.5])
    key = jax.random.PRNGKey(seed + 1)
    params0 = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(seed), x[:8]))  # host copy: steps donate
    results = {}
    with tempfile.TemporaryDirectory() as td:
        for cards in (1, len(devs)):
            mesh = make_mesh(cards)
            tr = LyapunovTrainer(model, _train_cfg(B), ds, run_dir=td,
                                 mesh=mesh)
            params = replicate(mesh, params0)
            bx, by = shard_batch(mesh, (x, y))
            grad_fn = jax.jit(jax.value_and_grad(
                lambda p, x, y: tr.loss_fn(p, x, y, key, 0, mixer, 2.0, True,
                                           0.0), has_aux=True))
            with jax.default_matmul_precision("highest"):
                (loss, _), g = grad_fn(params, bx, by)
                opt_state = replicate(mesh, tr.main_tx.init(params))
                t0 = time.perf_counter()
                _, _, _, step_loss, _ = tr._train_step(
                    params, opt_state, None, key, bx, by, jnp.asarray(0),
                    mixer, jnp.asarray(0.0), scale_nominal=True,
                    use_warmup_tx=False)
                step_loss = float(step_loss)
                out[f"step_seconds_with_compile_{cards}"] = (
                    time.perf_counter() - t0)
            if not np.isfinite(step_loss):
                raise AssertionError(f"data_parallel: loss {step_loss}")
            results[cards] = (float(loss), {
                jax.tree_util.keystr(k): np.asarray(v)
                for k, v in jax.tree_util.tree_leaves_with_path(g)})
    (l1, g1), (l4, g4) = results[1], results[len(devs)]
    out["loss"] = _check(abs(l4 - l1) / abs(l1), TOL_F32_REL)
    gmax = max(float(np.max(np.abs(a))) for a in g1.values())
    errs = {k: _max_err(g4[k], a) / gmax for k, a in g1.items()}
    out["grads"] = _check(max(errs.values()), TOL_F32_REL)
    # where the gradients differ most, and by how much as a whole
    out["grads"]["worst_leaves"] = sorted(
        errs.items(), key=lambda kv: -kv[1])[:3]
    out["grads"]["rel_l2"] = float(np.sqrt(
        sum(np.sum((g4[k] - a).astype(np.float64) ** 2) for k, a in g1.items())
        / sum(np.sum(a.astype(np.float64) ** 2) for a in g1.values())))
    _emit(out)


def phase_cert_mesh(devs, seed):
    import jax

    from fiode_tpu.cli import CONFIG_DIRS
    from fiode_tpu.experiment import (_load_cfg_dataset, _restore_params,
                                      build_model)
    from fiode_tpu.parallel.mesh import make_mesh2d
    from fiode_tpu.utils.config import compose
    from fiode_tpu.verify.certify import Certifier
    from fiode_tpu.verify.grid import enumerate_decision_boundary

    cfg = compose("cifar_certify.yaml", [], str(REPO / CONFIG_DIRS["certify"]))
    model = build_model(cfg)
    params = _restore_params(cfg, model, str(CKPT_RUN))
    ds = _load_cfg_dataset(cfg)
    idx = CERT_IMAGES
    images, labels = ds.test_x[idx], ds.test_y[idx]
    kw = dict(T=int(cfg["T"]), eps_input=float(cfg["eps"]),
              scale_nominal=bool(cfg["module"]["dynamics"]["scale_nominal"]))
    grid = enumerate_decision_boundary(10, kw["T"])
    out = {"phase": "cert_mesh", "mesh": [2, 2], "images": idx,
           "grid_cells": len(grid)}
    res = {}
    for name, mesh in (("unsharded", None), ("mesh2x2", make_mesh2d(2, 2))):
        cert = Certifier(model, params, grid=grid, mesh=mesh, **kw)
        t0 = time.perf_counter()
        r = cert.certify(images, labels, method="crown", early_exit=False)
        out[f"seconds_with_compile_{name}"] = time.perf_counter() - t0
        out[f"cells_per_sec_{name}"] = r.cells_per_sec
        res[name] = r
    out["certified_unsharded"] = res["unsharded"].certified.tolist()
    out["certified_mesh2x2"] = res["mesh2x2"].certified.tolist()
    if out["certified_unsharded"] != out["certified_mesh2x2"]:
        raise AssertionError("cert_mesh: certified sets differ")
    out["worst_diff"] = _max_err(res["mesh2x2"].worst,
                                 res["unsharded"].worst)
    _emit(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the multi-card paths (data-parallel "
                    "train step, 2x2 certification mesh)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(REPO))
    from fiode_tpu.utils.device import (device_record, enable_compile_cache,
                                        gpu_name_and_power_limit)

    # read before JAX starts: nvidia-smi runs as a child off JAX
    smi = gpu_name_and_power_limit()
    # the CPU reference needs the CPU backend beside the GPU one
    plat = os.environ.get("JAX_PLATFORMS")
    if plat and "cpu" not in plat.split(","):
        os.environ["JAX_PLATFORMS"] = plat + ",cpu"
    enable_compile_cache()
    import jax

    dev = device_record()
    print(f"jax device: {dev['platform']} {dev['kind']} x{dev['count']}",
          flush=True)
    if dev["platform"] != "gpu":
        sys.exit(f"chip_smoke: needs a GPU, JAX found {dev['platform']!r}")
    if dev["count"] < args.cards:
        sys.exit(f"chip_smoke: --cards {args.cards} but {dev['count']} found")
    print(f"nvidia-smi: {smi}", flush=True)
    gpu = jax.devices()[0]
    cpu = jax.devices("cpu")[0]

    if args.cards == 4:
        devs = jax.devices()[:4]
        phase_data_parallel(devs, args.seed)
        phase_cert_mesh(devs, args.seed)
    else:
        with jax.default_device(gpu):
            model, params = phase_forward_solve(gpu, cpu, args.seed)
            phase_train(gpu, cpu, args.seed)
            phase_certify(gpu, cpu, args.seed)
            phase_attack(gpu, cpu, args.seed, model, params)
            phase_fused_rhs(gpu, cpu, args.seed)
        phase_gpu_tests(gpu)
    print(json.dumps({"ok": True, "device": dev}))


if __name__ == "__main__":
    main()
