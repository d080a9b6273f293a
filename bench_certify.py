"""Secondary benchmark: CROWN grid cells certified per second (T=40, n=10).

The second north-star metric (BASELINE.json): throughput of the full
certification pipeline per (image, grid cell) pair — CROWN backward bounds
of the 10->128->128->10 ReLU dynamics twin over the 1/T Linf cell box,
diag-swapped interval propagation through the barrier QP (2n batched
bisections per cell), and the runner-up worst-case Vdot reduction
(reference certify_crown.py:131-153 inner loop).  As in the end-to-end
Certifier, a batch of images is vmapped into the same einsums so the
matmuls see (images x cells)-row operands — the reference certifies one image at
a time (certify_crown.py:122).

Methodology matches bench.py: chunks are swept inside one jitted fori_loop
ending in a host read-back, best-of-N.

Prints ONE JSON line {"metric", "value", "unit", "vs_baseline", "device",
"power_limit", ...}; vs_baseline uses an analytic estimate of the
reference's GPU throughput (~50k cells/s: auto_LiRPA CROWN on 103k-cell
batches at a few seconds per batch plus n-per-cell sequential QP python
loops).

Roofline keys (shared helper in bench.py): XLA's logical flop/byte count
of the compiled sweep over the measured wall time, against the device's
published peak for the sweep's matmul precision (float32 runs outside the
tensor cores, tensorfloat32 and bfloat16 on them).
"""
from __future__ import annotations

import argparse
import inspect
import json
import time

import numpy as np

def _qp_method():
    from fiode_tpu.ops.simplex_qp import qp_method_from_env
    return qp_method_from_env()

REF_CELLS_PER_SEC = 50_000.0
CHUNK = 4096
N_IMAGES = 8
N_INNER = 10
N_OUTER = 3


def _default_precision() -> str:
    """The Certifier's shipping matmul precision — the bench measures what
    the product runs (round-2 verdict: the kernel bench must not quote a
    precision the certifier no longer uses)."""
    from fiode_tpu.verify.certify import Certifier

    return inspect.signature(Certifier.__init__).parameters[
        "matmul_precision"
    ].default


# published peak (fiode_tpu.utils.device.PEAKS key) per matmul precision
PEAK_KEY = {"bfloat16": "bf16_flops_per_s",
            "tensorfloat32": "tf32_flops_per_s",
            "float32": "fp32_flops_per_s"}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--precision",
        default=None,
        choices=["bfloat16", "tensorfloat32", "float32"],
        help="matmul precision for the sweep (default: the Certifier's "
        "shipping default)",
    )
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from bench import device_header, roofline

    dev, smi, pk = device_header()
    precision = args.precision or _default_precision()

    from fiode_tpu.verify.crown import crown_mlp_bounds
    from fiode_tpu.verify.ibp_qp import ibp_cbf_qp, worst_case_vdot

    rng = np.random.default_rng(0)
    n, m = 10, 128
    Ws = [
        jnp.asarray(rng.normal(size=(m, n)).astype(np.float32)) / np.sqrt(n),
        jnp.asarray(rng.normal(size=(m, m)).astype(np.float32)) / np.sqrt(m),
        jnp.asarray(rng.normal(size=(n, m)).astype(np.float32)) / np.sqrt(m),
    ]
    bs = [jnp.zeros(m), jnp.zeros(m), jnp.zeros(n)]
    x_biases = jnp.asarray(
        rng.normal(size=(N_IMAGES, m)).astype(np.float32)
    )
    labels = jnp.asarray(np.arange(N_IMAGES) % n, jnp.int32)
    eta = rng.exponential(size=(CHUNK, n)).astype(np.float32)
    eta /= eta.sum(1, keepdims=True)
    eta = jnp.asarray(eta)
    eps = 1.0 / 40

    def sweep(Ws, bs, x_biases, labels, eta):
        def one(x_bias, label, e):
            xr = jnp.broadcast_to(x_bias, (e.shape[0], m))
            lb, ub = crown_mlp_bounds(Ws, bs, e, eps, xr)
            f_lb, f_ub = ibp_cbf_qp(e, eps, lb, ub, 100.0, 0.02, 20.0)
            return jnp.max(worst_case_vdot(e, eps, f_lb, f_ub, label))

        def body(i, worst):
            e = eta + i.astype(jnp.float32) * 1e-6
            v = jax.vmap(one, in_axes=(0, 0, None))(x_biases, labels, e)
            return jnp.maximum(worst, v)

        with jax.default_matmul_precision(precision):
            return jax.lax.fori_loop(
                0, N_INNER, body, jnp.full((N_IMAGES,), -jnp.inf)
            )

    compiled = jax.jit(sweep).lower(Ws, bs, x_biases, labels, eta).compile()
    float(compiled(Ws, bs, x_biases, labels, eta)[0])  # warmup
    best, best_dt = 0.0, None
    for _ in range(N_OUTER):
        t0 = time.time()
        float(compiled(Ws, bs, x_biases, labels, eta)[0])
        dt = time.time() - t0
        rate = N_INNER * CHUNK * N_IMAGES / dt
        if rate > best:
            best, best_dt = rate, dt

    extra = roofline(compiled, best_dt, pk[PEAK_KEY[precision]],
                     pk["hbm_bytes_per_s"])
    extra["flops_per_cell"] = round(
        extra["program_tflops"] * 1e12 / (N_INNER * CHUNK * N_IMAGES), 1
    )
    print(
        json.dumps(
            {
                "metric": "crown_grid_cells_certified_per_sec",
                "value": round(best, 1),
                "unit": f"image-cells/sec (T=40, n=10, mlp=128, "
                f"8 images batched, {precision} matmuls)",
                "vs_baseline": round(best / REF_CELLS_PER_SEC, 3),
                "device": dev,
                "power_limit": smi,
                "qp_method": _qp_method(),
                **extra,
            }
        )
    )


if __name__ == "__main__":
    main()
