"""Multi-host bootstrap (parallel/multihost.py) on a real 2-process CPU
cluster: both processes initialize the distributed runtime, build one
GLOBAL data mesh, assemble a sharded global batch from per-process rows,
and reduce over it with jit — the full ``--multihost`` train-step data
path minus the model (SURVEY §2.5 / §5.8: the reference's DDP equivalent,
sl_pipeline.py:163-165, crossed over hosts).
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]

_WORKER = r"""
import os, sys, json
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
sys.path.insert(0, %(repo)r)

from fiode_tpu.parallel.multihost import bootstrap_multihost, process_rows
idx, count = bootstrap_multihost()
assert count == 2, f"expected 2 processes, got {count}"
assert len(jax.devices()) == 4, jax.devices()  # 2 local x 2 processes

import jax.numpy as jnp
import numpy as np
from fiode_tpu.parallel.mesh import make_mesh, shard_batch

mesh = make_mesh()  # global mesh over all 4 devices
# deterministic-replicated global batch (same on both processes)
xs = np.arange(32, dtype=np.float32).reshape(8, 4) * 0.5
ys = np.arange(8, dtype=np.float32)
assert process_rows(8) == slice(idx * 4, idx * 4 + 4)
bx, by = shard_batch(mesh, (jnp.asarray(xs), jnp.asarray(ys)))
out = jax.jit(lambda a, b: (a.sum(-1) * b).mean())(bx, by)
print("RESULT", json.dumps({"idx": idx, "val": float(out)}), flush=True)
"""


def test_two_process_cpu_cluster(tmp_path):
    port = socket.socket()
    port.bind(("127.0.0.1", 0))
    addr = f"127.0.0.1:{port.getsockname()[1]}"
    port.close()

    procs = []
    for i in range(2):
        env = dict(
            os.environ,
            JAX_COORDINATOR_ADDRESS=addr,
            JAX_NUM_PROCESSES="2",
            JAX_PROCESS_ID=str(i),
            XLA_FLAGS="--xla_force_host_platform_device_count=2",
        )
        procs.append(
            subprocess.Popen(
                [sys.executable, "-c", _WORKER % {"repo": str(REPO)}],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True, cwd=str(tmp_path),
            )
        )
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multihost worker timed out")
        assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
        outs.append(out)

    vals = {}
    for out in outs:
        rec = json.loads(
            [l for l in out.splitlines() if l.startswith("RESULT")][-1]
            .split("RESULT ", 1)[1]
        )
        vals[rec["idx"]] = rec["val"]
    assert set(vals) == {0, 1}
    # both processes computed the same global reduction, equal to the
    # single-host value of the same program
    xs = np.arange(32, dtype=np.float32).reshape(8, 4) * 0.5
    ys = np.arange(8, dtype=np.float32)
    expect = float((xs.sum(-1) * ys).mean())
    assert vals[0] == pytest.approx(expect)
    assert vals[1] == pytest.approx(expect)
