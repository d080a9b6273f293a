"""fiode_tpu — a JAX framework for certified forward invariance in Neural ODEs.

A from-scratch JAX/XLA/Pallas rebuild of the capability surface of FI-ODE
("Certified and Robust Forward Invariance in Neural ODEs", arXiv 2210.16940;
reference implementation: yjhuangcd/FI-ODE, PyTorch).

Subpackages
-----------
ops      : differentiable simplex-cone projection QP, Cayley orthogonal layers,
           GroupSort, power iteration (the L0 numerics kernel layer).
ode      : adaptive & fixed-step Runge-Kutta integration (dopri5/dopri8/bosh3/
           fehlberg2/heun/euler/midpoint/rk4) on `lax.while_loop`/`lax.scan`,
           with batch-global torchdiffeq-compatible step control.
models   : Flax NNX-free pure-pytree model layer — Normalize, Cayley conv/linear
           backbones (KWLarge family), Lipschitz CNNs, simplex dynamics, IVP.
train    : Lyapunov certified training — samplers, schedulers, v_ndot via
           `jax.jvp`, kappa annealing, optax optimizers, sharded train step.
verify   : decision-boundary grid enumeration, from-scratch CROWN/IBP bound
           propagation, QP interval propagation, CROWN & Lipschitz certifiers.
attacks  : PGD (L2/Linf), APGD-CE/APGD-T/FAB/Square (AutoAttack suite).
control  : Segway safe-controller workload — analytic dynamics, LQR fit,
           barrier training, CROWN certification, closed-loop simulation.
parallel : mesh/sharding helpers for data-parallel training and sharded
           verification over the cards of one host.
utils    : config system, checkpointing, metric logging, simplex plotting.
"""

__version__ = "0.1.0"
