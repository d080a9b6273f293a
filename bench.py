"""Benchmark: dopri5 sample-NFE/sec/chip on the CIFAR-10 flagship model.

The driver's north-star metric (BASELINE.json): ODE right-hand-side
evaluations x samples per second per chip — each NFE is one full RHS on one
sample (4 matmuls + exp barrier + 30-iteration QP bisection), the inner loop
of inference, attack evaluation and Lipschitz certification.  The full
forward solve (KWLarge Cayley backbone + adaptive dopri5 at rtol=atol=1e-3,
the reference protocol from README.md:27 / pl_modules.py:18-35) is timed
end to end, with the RHS the backend picks (the fused Triton kernel on the
GPU, ops/fused_rhs.py).

Methodology: N_INNER independent solves run inside ONE jitted call
(fori_loop), each on a perturbed batch, ending in a host read-back;
best-of-N_OUTER.  The bounded-scan integrator runs a fixed trip budget with
a completion check.

``vs_baseline`` compares against an ANALYTIC estimate of the PyTorch/GPU
reference's throughput for the same computation (REF_SAMPLE_NFE_PER_SEC):
the reference executes each RHS as a stream of ~40+ small CUDA kernels
(barrier_projection.py:241-255 is a 30-iteration Python loop of elementwise
kernels), making it kernel-launch-latency bound at roughly 150k
sample-NFE/s on a V100-class GPU.  The repo publishes no measured numbers
(BASELINE.md), so this constant is the documented stand-in until a measured
GPU run replaces it.

Roofline grounding: the compiled program's own XLA cost analysis (logical
flops + bytes accessed) over the measured wall time, against the device's
published peaks (fiode_tpu.utils.device.PEAKS; float32 matmuls at the
default precision run in TF32, so the TF32 peak applies).  A device with no
entry in the table is an error.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device",
"power_limit", ...roofline keys}.
"""
from __future__ import annotations

import dataclasses
import json
import time

import numpy as np

REF_SAMPLE_NFE_PER_SEC = 150_000.0


def _qp_method():
    from fiode_tpu.ops.simplex_qp import qp_method_from_env
    return qp_method_from_env()


def roofline(compiled, dt: float, peak_flops: float, peak_bytes: float) -> dict:
    """Roofline keys from a compiled program's XLA cost analysis.

    ``compiled`` is a jax AOT Compiled object; ``dt`` the measured seconds
    for one execution of it; the peaks are the device's published rates.
    """
    ca = compiled.cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0]
    flops = float(ca["flops"])
    bytes_ = float(ca.get("bytes accessed", 0.0))
    pf = flops / dt / peak_flops
    ph = bytes_ / dt / peak_bytes
    return {
        "program_tflops": round(flops / 1e12, 3),
        "achieved_tflops_per_s": round(flops / dt / 1e12, 3),
        "pct_peak_flops": round(100 * pf, 2),
        "program_gbytes": round(bytes_ / 1e9, 3),
        "achieved_hbm_gb_per_s": round(bytes_ / dt / 1e9, 1),
        "pct_peak_hbm": round(100 * ph, 2),
        "bound": "flops" if pf >= ph else "hbm",
    }


def device_header() -> tuple:
    """(device record, nvidia-smi power line, published peaks): turns on
    the compile cache and fails on a device without published peaks."""
    from fiode_tpu.utils.device import (device_record, enable_compile_cache,
                                        gpu_name_and_power_limit, peaks)

    smi = gpu_name_and_power_limit()
    enable_compile_cache()
    dev = device_record()
    return dev, smi, peaks(dev["kind"])


# the bench's batch since its first version; on an H100 the B=32768 solve
# peaks at ~16 GB of device memory (chip_smoke.py phase 5)
BATCH = 32768
N_INNER = 6  # solves per jitted call
N_OUTER = 4  # timed calls; best one reported
# Bounded-scan step budget.  The scan integrator executes EVERY trip's
# full RK step (6 RHS evals) and masks the state update once t reaches
# t_final, so budget trips beyond the solve's real attempt count are pure
# device waste the NFE metric never credits.  Measured: these solves take
# 5 accepted + 0 rejected attempts at tol 1e-3 (batch-global RMS
# control), so 8 leaves 3 spare attempts; the run ASSERTS completion
# (max attempts < MAX_STEPS) and fails loudly rather than silently
# truncating if the dynamics ever get stiffer.
MAX_STEPS = 8


def main():
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _flagship

    dev, smi, pk = device_header()
    model = dataclasses.replace(_flagship(), max_steps=MAX_STEPS)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.uniform(0, 1, (BATCH, 3, 32, 32)).astype(np.float32))
    params = jax.jit(model.init)(jax.random.PRNGKey(0), x[:8])

    def make_many_solves(k):
        def many_solves(params, x):
            def body(i, carry):
                nfe_total, acc, att = carry
                # defeat CSE across iters
                xi = x + (i.astype(jnp.float32) * 1e-5)
                sol = model.solve(params, xi, mode="scan")
                att = jnp.maximum(att, sol.n_accepted + sol.n_rejected)
                return nfe_total + sol.nfe, acc + sol.ys[-1], att

            return jax.lax.fori_loop(
                0, k, body,
                (jnp.zeros((), jnp.int32), jnp.zeros((BATCH, 10)),
                 jnp.zeros((), jnp.int32)),
            )

        return many_solves

    def timed(compiled, n_outer):
        """(best sample-NFE/s, its dt, NFE count) over n_outer calls."""
        best = best_dt = n = None
        for _ in range(n_outer):
            t0 = time.time()
            nfe, acc, att = compiled(params, x)
            n = int(nfe)  # host read-back ends the timed region
            dt = time.time() - t0
            # completion check: a solve that exhausts the trip budget may
            # have been truncated mid-integration — fail the bench rather
            # than report throughput for an unfinished solve
            if int(att) >= MAX_STEPS:
                raise RuntimeError(
                    f"solver hit the MAX_STEPS={MAX_STEPS} trip budget "
                    f"(attempts={int(att)}); raise MAX_STEPS"
                )
            rate = n * BATCH / dt
            if best is None or rate > best:
                best, best_dt = rate, dt
        return best, best_dt, n

    # AOT-compile so the same executable serves timing AND cost analysis
    t0 = time.perf_counter()
    compiled = jax.jit(make_many_solves(N_INNER)).lower(params, x).compile()
    compile_seconds = time.perf_counter() - t0
    nfe, acc, _ = compiled(params, x)  # warmup
    acc.block_until_ready()
    best, best_dt, n = timed(compiled, N_OUTER)

    extra = roofline(compiled, best_dt, pk["tf32_flops_per_s"],
                     pk["hbm_bytes_per_s"])
    # whole-program flops (N_INNER solves: KWLarge backbone + scan'd RHS
    # evals) amortized over the sample-NFEs the metric counts
    extra["flops_per_sample_nfe"] = round(
        extra["program_tflops"] * 1e12 / (n * BATCH), 1
    )
    print(
        json.dumps(
            {
                "metric": "dopri5_sample_nfe_per_sec_per_chip",
                "value": round(best, 1),
                "unit": "RHS evals * samples / sec",
                "vs_baseline": round(best / REF_SAMPLE_NFE_PER_SEC, 3),
                "device": dev,
                "power_limit": smi,
                "compile_seconds": round(compile_seconds, 1),
                "peak_bytes_in_use": jax.devices()[0].memory_stats()[
                    "peak_bytes_in_use"],
                "qp_method": _qp_method(),
                **extra,
            }
        )
    )


if __name__ == "__main__":
    main()
