"""Lyapunov certified training: sharded train step, optimizers, fit loop.

Rebuild of the reference's training stack — LightningModules
(pl_modules.py:68-523) + SLExperiment/Trainer (sl_pipeline.py:130-264) — as
a functional JAX trainer:

  * one jitted ``train_step`` holding the entire hot path (backbone forward,
    sampler draw, jvp Lyapunov loss, optimizer update) — batch sharded over a
    1-D data mesh, params replicated, gradients mean-reduced by XLA's all-reduce;
  * optimizers: Adam / AdamW / SGD (+momentum), torch-style L2 weight decay,
    cosine-annealing or multistep LR per epoch, and the reference's
    warmup-epoch optimizer swap (pl_modules.py:139-147,160-164);
  * kappa annealing / Lipschitz-aware kappa, scale_nominal auto-off at
    ``epoch_off_scale`` (pl_modules.py:391-393), optional blended ODE CE loss
    after ``train_ode_epoch`` (pl_modules.py:490-502);
  * PGD adversarial training on the Lyapunov objective itself
    (pl_modules.py:149-158,170-176) and PGD-5 validation attacks
    (pl_modules.py:185-220);
  * epoch timing (the reference's TimingCallback, sl_pipeline.py:100-127),
    JSONL metrics, numpy best/last checkpoints monitored on
    validation_(adv_)error (sl_pipeline.py:143-154).
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..attacks.pgd import pgd_attack
from ..models.ivp import NeuralODEClassifier
from ..parallel.mesh import make_mesh, replicate, shard_batch
from ..utils.checkpoint import CheckpointManager
from ..utils.logging import MetricWriter
from .data import Dataset, augment_batch
from .lips import compute_lfx, lfx_init
from .lyapunov import (
    LyapunovMetrics,
    anneal_kappa,
    get_lya_candidate,
    lips_kappa,
    lyapunov_loss,
)
from .samplers import composite_sample
from .schedulers import CompositeSamplerScheduler


def _zero_metrics(loss):
    z = jnp.zeros(())
    return LyapunovMetrics(
        loss=loss, monte_carlo_loss=z, barrier_loss=z, kappa=z,
        effective_batch_size=jnp.zeros((), jnp.int32).astype(jnp.float32),
        mean_active_constraints=z, mean_v=z, mean_vdot=z,
    )

__all__ = ["TrainConfig", "LyapunovTrainer"]


@dataclasses.dataclass
class TrainConfig:
    # optimisation (reference GeneralModule node, ExpConfig.py:198-216)
    opt_name: str = "Adam"
    lr: float = 5e-3
    momentum: float = 0.9
    weight_decay: float = 0.0
    beta1: float = 0.9
    beta2: float = 0.999
    scheduler_name: str = "cos_anneal"  # 'cos_anneal' | 'step' | 'none'
    decay_epochs: Sequence[int] = (90, 120, 150)
    max_epochs: int = 300
    warmup: int = -1  # epochs of the warmup Adam(1e-3, wd 5e-4); -1 = off
    fix_backbone: bool = False
    # data
    batch_size: int = 128
    val_batch_size: int = 256
    augment: bool = True
    # objective: 'lyapunov' (LyapunovLearning), 'ode' (ODELearning plain CE
    # through the solve), 'classical' (ClassicalLearning plain CNN)
    objective: str = "lyapunov"
    # lyapunov (reference Lyapunov node, ExpConfig.py:240-256)
    h_sample_size: int = 256
    h_dist_lim: float = 15.0
    act: str = "relu"
    lya_cand: str = "DecisionBoundary"
    lya_log_mode: bool = False
    sampler_names: Sequence[str] = ("UniformSimplexSampling", "CorrectConeSampling")
    barrier_loss: bool = False
    relax_exp_stable: bool = False
    scale_l_eps: float = 3.0
    lips_train: bool = False
    lips_warmup: int = 0
    epoch_off_scale: int = 10
    train_ode: bool = False
    train_ode_epoch: int = 100
    # adversarial
    adv_train: bool = False
    val_adv: bool = False
    eps: float = 36 / 255
    norm: str = "L2"
    # misc
    seed: int = 0
    log_every: int = 20
    simplex: bool = True
    # optimizer steps fused into one jitted call (amortises per-dispatch
    # latency)
    steps_per_call: int = 1


class LyapunovTrainer:
    def __init__(
        self,
        model: NeuralODEClassifier,
        cfg: TrainConfig,
        dataset: Dataset,
        scheduler: Optional[CompositeSamplerScheduler] = None,
        run_dir: str = "run_data/default",
        mesh=None,
        writer: Optional[MetricWriter] = None,
    ):
        self.model = model
        self.cfg = cfg
        self.ds = dataset
        self.mesh = mesh if mesh is not None else make_mesh()
        self.scheduler = scheduler
        self.writer = writer or MetricWriter(run_dir, config=dataclasses.asdict(cfg))
        monitor = "validation_adv_error" if cfg.val_adv else "validation_error"
        self.ckpt = CheckpointManager(run_dir, monitor=monitor)
        self.n = model.dynamics.n_hidden
        self.lya = get_lya_candidate(
            cfg.lya_cand, self.n, log_mode=cfg.lya_log_mode
        )
        self.steps_per_epoch = max(1, len(dataset.train_x) // cfg.batch_size)
        self._build_optimizers()
        self._train_step = self._make_train_step()
        self._eval_step = self._make_eval_step()
        # the scale_nominal of the current/last trained phase — the
        # reference mutates the module attribute at epoch_off_scale
        # (pl_modules.py:391-393); updated by fit(), consumed by
        # evaluate()/test_autoattack() so post-training inference
        # integrates the field that was actually trained
        self._phase_scale_nominal = bool(model.dynamics.scale_nominal)

    # -- optimizers ----------------------------------------------------------

    def _lr_schedule(self):
        cfg = self.cfg
        spe = self.steps_per_epoch

        def sched(step):
            epoch = step // spe
            if cfg.scheduler_name == "cos_anneal":
                return cfg.lr * 0.5 * (1.0 + jnp.cos(jnp.pi * epoch / cfg.max_epochs))
            if cfg.scheduler_name == "step":
                factor = jnp.asarray(1.0)
                for m in cfg.decay_epochs:
                    factor = jnp.where(epoch >= m, factor * 0.1, factor)
                return cfg.lr * factor
            return jnp.asarray(cfg.lr)

        return sched

    def _main_optimizer(self):
        cfg = self.cfg
        sched = self._lr_schedule()
        if cfg.opt_name == "Adam":
            core = optax.adam(sched, b1=cfg.beta1, b2=cfg.beta2)
            tx = optax.chain(
                optax.add_decayed_weights(cfg.weight_decay), core
            ) if cfg.weight_decay else core
        elif cfg.opt_name == "AdamW":
            tx = optax.adamw(sched, b1=cfg.beta1, b2=cfg.beta2,
                             weight_decay=cfg.weight_decay)
        elif cfg.opt_name == "SGD":
            core = optax.sgd(sched, momentum=cfg.momentum)
            tx = optax.chain(
                optax.add_decayed_weights(cfg.weight_decay), core
            ) if cfg.weight_decay else core
        else:
            raise ValueError(cfg.opt_name)
        if cfg.fix_backbone:
            # train the dynamics only (reference SGD fix_backbone path,
            # pl_modules.py:110-114)
            def label(params):
                return {k: ("train" if k == "dynamics" else "frozen")
                        for k in params}

            tx = optax.multi_transform(
                {"train": tx, "frozen": optax.set_to_zero()}, label
            )
        return tx

    def _build_optimizers(self):
        self.warmup_tx = optax.chain(
            optax.add_decayed_weights(5e-4), optax.adam(1e-3)
        )
        self.main_tx = self._main_optimizer()

    # -- train step ----------------------------------------------------------

    def _make_train_step(self):
        cfg = self.cfg
        model = self.model
        lya = self.lya
        sampler_names = tuple(cfg.sampler_names)
        n = self.n
        dyn = model.dynamics

        def ode_ce_loss(params, x, y, scale_nominal):
            """Plain CE/NLL through the ODE solve (ODELearning.compute_loss,
            pl_modules.py:328-335)."""
            probs = model.output_fn(
                model.solve(params, x, mode="scan",
                            scale_nominal=scale_nominal).ys[-1],
                params.get("output"),
            )
            if cfg.simplex:
                p_y = jnp.take_along_axis(probs, y[:, None], axis=-1)[:, 0]
                return -jnp.mean(jnp.log(jnp.clip(p_y, 1e-12)))
            return -jnp.mean(
                jax.nn.log_softmax(probs)[jnp.arange(y.shape[0]), y]
            )

        def compute_loss(params, x, y, key, step, mixer, kappa,
                         scale_nominal):
            if cfg.objective == "classical":
                # plain supervised CNN (ClassicalLearning,
                # pl_modules.py:247-270): the backbone IS the model
                logits = model.features(params, x)
                loss = -jnp.mean(
                    jax.nn.log_softmax(logits)[jnp.arange(y.shape[0]), y]
                )
                return loss, _zero_metrics(loss)
            if cfg.objective == "ode":
                loss = ode_ce_loss(params, x, y, scale_nominal)
                return loss, _zero_metrics(loss)

            B = x.shape[0]
            S = cfg.h_sample_size
            k_samp, k_drop = jax.random.split(key)
            feats = model.features(params, x)  # (B, d)
            extra = {}
            if "TrajectorySampler" in sampler_names:
                extra = dict(model=model, params=params, x=x)
            h = composite_sample(
                k_samp, sampler_names, mixer, y, n, S,
                h_dist_lim=cfg.h_dist_lim, **extra,
            )  # (B, S, n)
            h = jax.lax.stop_gradient(h.reshape(B * S, n))
            x_in = jnp.repeat(feats, S, axis=0)  # (B*S, d)
            y_in = jnp.repeat(y, S, axis=0)

            f = model.eval_dot(
                params, h, x_in, train=True, rng=k_drop,
                scale_nominal=scale_nominal,
            )
            f_tilde = (
                model.raw_dot(params, h, x_in) if cfg.barrier_loss else None
            )
            loss, metrics = lyapunov_loss(
                h=h, f=f, f_tilde=f_tilde, y=y_in, lya_cand=lya,
                output_fn=lambda h_: model.output_fn(h_, params.get("output")),
                current_kappa=kappa,
                alpha_1=dyn.alpha_1, alpha_2=dyn.alpha_2, act=cfg.act,
                relax_exp_stable=cfg.relax_exp_stable,
                scale_l_eps=cfg.scale_l_eps, eps=cfg.eps,
                barrier_loss=cfg.barrier_loss,
            )
            return loss, metrics

        def full_loss(params, x, y, key, step, mixer, kappa, scale_nominal,
                      ode_portion):
            loss, metrics = compute_loss(
                params, x, y, key, step, mixer, kappa, scale_nominal
            )
            if cfg.train_ode and cfg.objective == "lyapunov":
                # blended true-ODE CE loss (pl_modules.py:490-502); portion is
                # 0 until train_ode_epoch then ramps to 0.98 over 50 epochs.
                loss_ode = ode_ce_loss(params, x, y, scale_nominal)
                loss = loss * (1.0 - ode_portion) + loss_ode * ode_portion
            return loss, metrics

        input_shape = self.ds.image_shape

        def step_body(params, opt_state, lfx_state, key, x, y, step, mixer,
                      ode_portion, scale_nominal, use_warmup_tx):
            k_aug, k_adv, k_loss = jax.random.split(key, 3)
            if cfg.augment and self.ds.name.startswith("CIFAR"):
                # crop+flip are CIFAR-only in the reference transforms
                # (dataset_loaders.py:68-74 vs :19-23)
                x = augment_batch(k_aug, x)

            # kappa: Lipschitz-aware (pl_modules.py:437-445) or linear anneal
            if cfg.lips_train and lfx_state is not None:
                Lfx, lfx_state = compute_lfx(
                    model.backbone, params["backbone"], lfx_state, input_shape
                )
                kappa = lips_kappa(
                    step, dyn.kappa, dyn.kappa_length, cfg.eps, Lfx,
                    cfg.lips_warmup,
                )
            else:
                Lfx = jnp.asarray(1.0)
                kappa = anneal_kappa(step, dyn.kappa, dyn.kappa_length)

            if cfg.adv_train:
                # PGD on the training objective itself (advertorch target
                # compute_loss; pl_modules.py:149-158)
                def adv_obj(xa):
                    l, _ = compute_loss(
                        params, xa, y, k_loss, step, mixer, kappa,
                        scale_nominal,
                    )
                    return l[None]

                x = pgd_attack(
                    adv_obj, x, k_adv, eps=cfg.eps, norm=cfg.norm, steps=7,
                    step_size=2.5 * cfg.eps / 7,
                )
                x = jax.lax.stop_gradient(x)

            (loss, metrics), grads = jax.value_and_grad(
                full_loss, has_aux=True
            )(params, x, y, k_loss, step, mixer, kappa, scale_nominal,
              ode_portion)
            tx = self.warmup_tx if use_warmup_tx else self.main_tx
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            md = metrics._asdict()
            md["Lips"] = Lfx
            return params, opt_state, lfx_state, loss, md

        @functools.partial(
            jax.jit,
            static_argnames=("scale_nominal", "use_warmup_tx"),
            donate_argnums=(0, 1, 2),
        )
        def train_step(params, opt_state, lfx_state, key, x, y, step, mixer,
                       ode_portion, *, scale_nominal, use_warmup_tx):
            return step_body(
                params, opt_state, lfx_state, key, x, y, step, mixer,
                ode_portion, scale_nominal, use_warmup_tx,
            )

        @functools.partial(
            jax.jit,
            static_argnames=("scale_nominal", "use_warmup_tx"),
            donate_argnums=(0, 1, 2),
        )
        def train_multi_step(params, opt_state, lfx_state, key, xs, ys,
                             step0, mixer, ode_portion, *, scale_nominal,
                             use_warmup_tx):
            """K optimizer steps in ONE program: xs (K, B, ...), ys (K, B).

            One device sync per K steps — removes per-step dispatch
            overhead."""
            K = xs.shape[0]

            def body(i, carry):
                params, opt_state, lfx_state, key, _, _ = carry
                key, k = jax.random.split(key)
                params, opt_state, lfx_state, loss, md = step_body(
                    params, opt_state, lfx_state, k, xs[i], ys[i],
                    step0 + i, mixer, ode_portion, scale_nominal,
                    use_warmup_tx,
                )
                return params, opt_state, lfx_state, key, loss, md

            # unrolled first step fixes the carry structure (metrics dict)
            carry = body(
                0, (params, opt_state, lfx_state, key, jnp.zeros(()), None)
            )
            if K > 1:
                carry = jax.lax.fori_loop(1, K, body, carry)
            params, opt_state, lfx_state, _, loss, md = carry
            return params, opt_state, lfx_state, loss, md

        self._train_multi_step = train_multi_step
        # the objective itself (no augmentation, kappa passed in): what a
        # reference or a sharded run compares one step's loss and gradients
        # against
        self.loss_fn = full_loss
        return train_step

    # -- eval ----------------------------------------------------------------

    def _make_eval_step(self):
        cfg = self.cfg
        model = self.model

        def predict_with_nfe(params, x, sn):
            if cfg.objective == "classical":
                # ClassicalLearning trains ONLY the backbone — validating
                # through the (untrained) ODE solve would select
                # checkpoints on noise (pl_modules.py:247-270: the plain
                # CNN is the model)
                return (
                    jax.nn.softmax(model.features(params, x)),
                    jnp.zeros((), jnp.int32),
                )
            sol = model.solve(params, x, mode="while", scale_nominal=sn)
            return (
                model.output_fn(sol.ys[-1], params.get("output")),
                sol.nfe,
            )

        def predict(params, x, sn):
            return predict_with_nfe(params, x, sn)[0]

        def predict_diff(params, x, sn):
            if cfg.objective == "classical":
                return jax.nn.softmax(model.features(params, x))
            return model.output_fn(
                model.solve(params, x, mode="scan", scale_nominal=sn).ys[-1],
                params.get("output"),
            )

        # scale_nominal is the CURRENT training phase's value: the
        # reference mutates dyn_fun.scale_nominal permanently at
        # epoch_off_scale (pl_modules.py:391-393), so validation/test must
        # integrate the same field the phase trains — not the dynamics
        # module's static constructor flag
        @functools.partial(jax.jit, static_argnames=("scale_nominal",))
        def eval_step(params, key, x, y, *, scale_nominal):
            sn = scale_nominal
            probs, nfe = predict_with_nfe(params, x, sn)
            err = jnp.mean((jnp.argmax(probs, -1) != y).astype(jnp.float32))
            if cfg.simplex:
                logp = jnp.log(jnp.clip(probs, 1e-12))
                loss = -jnp.mean(
                    jnp.take_along_axis(logp, y[:, None], axis=-1)
                )
            else:
                loss = -jnp.mean(
                    jax.nn.log_softmax(probs)[jnp.arange(y.shape[0]), y]
                )
            if cfg.val_adv:
                # 5-step PGD on cross-entropy of the ODE solution
                # (torchattacks PGD/PGDL2; pl_modules.py:191-199)
                def ce(xa):
                    p = predict_diff(params, xa, sn)
                    p_y = jnp.take_along_axis(
                        jnp.clip(p, 1e-12), y[:, None], axis=-1
                    )[:, 0]
                    return -jnp.log(p_y)

                x_adv = pgd_attack(
                    ce, x, key, eps=cfg.eps, norm=cfg.norm, steps=5,
                    step_size=2.5 * cfg.eps / 10,
                )
                probs_adv = predict(params, x_adv, sn)
                err_adv = jnp.mean(
                    (jnp.argmax(probs_adv, -1) != y).astype(jnp.float32)
                )
            else:
                err_adv = err
            return {
                "validation_loss": loss,
                "validation_error": err,
                "validation_adv_error": err_adv,
                "simplex_min": jnp.min(probs),
                "simplex_max": jnp.max(probs),
                "val_nfe": nfe.astype(jnp.float32),
            }

        return eval_step

    # -- loops ---------------------------------------------------------------

    def _epoch_mixer(self, epoch: int) -> np.ndarray:
        if self.scheduler is None:
            k = len(self.cfg.sampler_names)
            return np.full((k,), 1.0 / k, np.float32)
        return np.asarray(
            self.scheduler.get_mixer_coefficients(epoch), np.float32
        )

    def _ode_portion(self, epoch: int) -> float:
        if not self.cfg.train_ode or epoch <= self.cfg.train_ode_epoch:
            return 0.0
        return min(0.98, (epoch - self.cfg.train_ode_epoch) / 50.0)

    def _batches(self, rng: np.random.Generator, xs, ys, bs, drop_last=True):
        idx = rng.permutation(len(xs))
        n_full = len(xs) // bs
        for i in range(n_full):
            j = idx[i * bs : (i + 1) * bs]
            yield xs[j], ys[j]
        if not drop_last and len(xs) % bs:
            j = idx[n_full * bs :]
            yield xs[j], ys[j]

    def fit(self, epochs: Optional[int] = None, eval_every: int = 1,
            resume: bool = False):
        """Train; ``resume=True`` continues from the run dir's 'resume'
        checkpoint (params + optimizer state + PRNG key + step/epoch,
        written at every eval boundary) — Lightning's
        resume_from_checkpoint equivalent, so a killed multi-hour run
        continues where it stopped.  The numpy shuffle
        stream is fast-forwarded by the completed epoch count, so a
        resumed run replays the exact uninterrupted batch order; only the
        Lipschitz power-iteration state (lips_train) re-warms from init.
        """
        cfg = self.cfg
        epochs = epochs if epochs is not None else cfg.max_epochs
        rng_np = np.random.default_rng(cfg.seed)
        key = jax.random.PRNGKey(cfg.seed)

        x0 = jnp.asarray(self.ds.train_x[: cfg.batch_size])
        # jit the init: eager init dispatches hundreds of small ops one by one
        params = jax.jit(self.model.init)(jax.random.PRNGKey(cfg.seed), x0)
        params = replicate(self.mesh, params)
        use_warmup = cfg.warmup > 0
        tx = self.warmup_tx if use_warmup else self.main_tx
        opt_state = replicate(self.mesh, tx.init(params))
        lfx_state = None
        if cfg.lips_train and "backbone" in params:
            lfx_state = lfx_init(
                self.model.backbone, params["backbone"],
                self.ds.image_shape, jax.random.PRNGKey(cfg.seed + 1),
            )
            if lfx_state is not None:
                lfx_state = replicate(self.mesh, lfx_state)

        step = 0
        start_epoch = 0
        if resume and self.ckpt.has_resume:
            meta = self.ckpt.resume_meta()
            start_epoch = int(meta["epoch"]) + 1
            # the tx active when the state was saved (end of meta["epoch"]):
            # warmup iff that epoch was before the swap boundary
            use_warmup = cfg.warmup > 0 and int(meta["epoch"]) < cfg.warmup
            tx = self.warmup_tx if use_warmup else self.main_tx
            host = lambda t: jax.tree_util.tree_map(np.asarray, t)
            like = {
                "params": host(params),
                "opt_state": host(tx.init(params)),
                "key": np.asarray(key),
                "step": 0,
                "epoch": 0,
            }
            state = self.ckpt.restore_resume(like=like)
            params = replicate(self.mesh, state["params"])
            opt_state = replicate(self.mesh, state["opt_state"])
            key = jnp.asarray(state["key"])
            step = int(state["step"])
            # replay the epoch shuffles the interrupted run consumed
            for _ in range(start_epoch):
                rng_np.permutation(len(self.ds.train_x))
            self.writer.console(
                f"resumed from epoch {meta['epoch']} (step {step})"
            )
        for epoch in range(start_epoch, epochs):
            if use_warmup and epoch == cfg.warmup:
                # optimizer swap at the warmup boundary (pl_modules.py:160-164)
                use_warmup = False
                opt_state = replicate(self.mesh, self.main_tx.init(params))
            scale_nominal = (
                self.model.dynamics.scale_nominal
                and epoch < cfg.epoch_off_scale
            )
            self._phase_scale_nominal = bool(scale_nominal)
            mixer = jnp.asarray(self._epoch_mixer(epoch))
            ode_portion = jnp.asarray(self._ode_portion(epoch), jnp.float32)

            t_epoch = time.time()
            spc = max(1, cfg.steps_per_call)
            # datasets smaller than one batch yield zero steps (drop_last);
            # the eval console line must not NameError on 'loss' then
            loss = jnp.asarray(float("nan"))
            group_x, group_y = [], []
            for bx, by in self._batches(
                rng_np, self.ds.train_x, self.ds.train_y, cfg.batch_size
            ):
                group_x.append(bx)
                group_y.append(by)
                if len(group_x) < spc:
                    continue
                key, k = jax.random.split(key)
                if spc == 1:
                    batch = shard_batch(
                        self.mesh, (jnp.asarray(group_x[0]),
                                    jnp.asarray(group_y[0]))
                    )
                    params, opt_state, lfx_state, loss, metrics = (
                        self._train_step(
                            params, opt_state, lfx_state, k, batch[0],
                            batch[1], jnp.asarray(step), mixer, ode_portion,
                            scale_nominal=bool(scale_nominal),
                            use_warmup_tx=use_warmup,
                        )
                    )
                else:
                    # (K, B, ...) stacked group: shard the batch axis (dim 1)
                    from jax.sharding import NamedSharding, PartitionSpec

                    def put(a):
                        spec = PartitionSpec(None, "data",
                                             *([None] * (a.ndim - 2)))
                        return jax.device_put(
                            a, NamedSharding(self.mesh, spec)
                        )

                    xs = put(jnp.asarray(np.stack(group_x)))
                    ys = put(jnp.asarray(np.stack(group_y)))
                    params, opt_state, lfx_state, loss, metrics = (
                        self._train_multi_step(
                            params, opt_state, lfx_state, k, xs, ys,
                            jnp.asarray(step), mixer, ode_portion,
                            scale_nominal=bool(scale_nominal),
                            use_warmup_tx=use_warmup,
                        )
                    )
                group_x, group_y = [], []
                if (step // spc) % max(1, cfg.log_every // spc) == 0:
                    m = {"training_loss": loss, **metrics}
                    m.update(
                        {f"mixing_weight_{i}": float(w)
                         for i, w in enumerate(np.asarray(mixer))}
                    )
                    self.writer.log(m, step=step, epoch=epoch)
                step += spc
            # flush the trailing partial group one step at a time
            for bx, by in zip(group_x, group_y):
                key, k = jax.random.split(key)
                batch = shard_batch(
                    self.mesh, (jnp.asarray(bx), jnp.asarray(by))
                )
                params, opt_state, lfx_state, loss, metrics = (
                    self._train_step(
                        params, opt_state, lfx_state, k, batch[0], batch[1],
                        jnp.asarray(step), mixer, ode_portion,
                        scale_nominal=bool(scale_nominal),
                        use_warmup_tx=use_warmup,
                    )
                )
                step += 1
            train_time = time.time() - t_epoch

            if (epoch + 1) % eval_every == 0 or epoch == epochs - 1:
                t_val = time.time()
                val = self.evaluate(params, key)
                val["train_epoch_time"] = train_time
                val["val_epoch_time"] = time.time() - t_val
                self.writer.log(val, step=step, epoch=epoch)
                self.writer.console(
                    f"epoch {epoch}: loss={float(loss):.4f} "
                    f"val_err={val['validation_error']:.4f} "
                    f"adv_err={val['validation_adv_error']:.4f} "
                    f"({train_time:.1f}s train)"
                )
                state = {"params": params, "step": step}
                self.ckpt.maybe_save_best(state, val, step)
                self.ckpt.save_last(state, val, step)
                self.ckpt.save_resume(
                    {"params": params, "opt_state": opt_state,
                     "key": key, "step": step, "epoch": epoch},
                    epoch, step,
                )
                self._maybe_plot_simplex(params, key, epoch)
        return params

    def _maybe_plot_simplex(self, params, key, epoch):
        """3-class runs: per-epoch simplex sample/trajectory figures
        (reference pl_modules.py:508-523, utils.py:30-140)."""
        if self.n != 3:
            return
        try:
            from ..utils.plotting import (
                plot_samples_on_3_simplex,
                plot_traj_on_3_simplex,
            )

            plots = self.ckpt.dir.parent / "plots"
            plots.mkdir(exist_ok=True)
            k1, k2 = jax.random.split(key)
            y = jnp.asarray(self.ds.val_y[:16])
            mixer = jnp.asarray(self._epoch_mixer(epoch))
            h = composite_sample(
                k1, tuple(self.cfg.sampler_names), mixer, y, 3, 64,
                h_dist_lim=self.cfg.h_dist_lim,
            ).reshape(-1, 3)
            plot_samples_on_3_simplex(
                np.asarray(h), save=str(plots / f"samples_e{epoch:04d}.png")
            )
            x = jnp.asarray(self.ds.val_x[:16])
            traj = jax.jit(
                lambda p, x: self.model.trajectory(
                    p, x, n_points=50,
                    scale_nominal=self._phase_scale_nominal,
                )
            )(params, x)
            plot_traj_on_3_simplex(
                np.asarray(traj), np.asarray(y),
                save=str(plots / f"traj_e{epoch:04d}.png"),
            )
        except Exception as e:  # plotting must never kill training
            self.writer.console(f"[plot] skipped: {e}")

    def test_autoattack(self, params, key, attacks=("apgd-ce", "apgd-t"),
                        max_batches=None, n_iter=100, t_max=None,
                        max_steps=32, eps=None):
        """Test-time AutoAttack evaluation (reference test_step,
        pl_modules.py:222-244: apgd-ce + apgd-t at eps/norm).

        ``t_max`` shortens the attack-time integration horizon (the
        reference evaluates AutoAttack at t_max=0.1, README.md:51 /
        eval_autoattack protocol) — attacks through the ODE are dominated by
        solve depth.  ``eps`` overrides the config attack radius — callers
        comparing against a certificate must attack at the SAME radius the
        certificate used, or certified ⊆ robust need not hold."""
        import dataclasses as _dc

        from ..attacks.autoattack import AutoAttackSuite

        model = self.model
        if t_max is not None or max_steps is not None:
            model = _dc.replace(
                model,
                t_max=t_max if t_max is not None else model.t_max,
                max_steps=max_steps if max_steps is not None else model.max_steps,
            )

        # jitted: the suite also calls this for clean/robust checks, and an
        # eager op stream dispatches every small op separately
        @jax.jit
        def logits_fn(x):
            return model.output_fn(
                model.solve(
                    params, x, mode="scan",
                    scale_nominal=self._phase_scale_nominal,
                ).ys[-1],
                params.get("output"),
            )

        suite = AutoAttackSuite(
            logits_fn, eps=self.cfg.eps if eps is None else float(eps),
            norm=self.cfg.norm, attacks_to_run=attacks, n_iter=n_iter,
        )
        bs = self.cfg.val_batch_size
        xs, ys = self.ds.test_x, self.ds.test_y
        # ceil: the tail batch must be evaluated too (a shorter final batch
        # costs one extra compile, once — dropping it silently skews the
        # robust-accuracy denominator)
        n_batches = max(1, -(-len(xs) // bs))
        if max_batches:
            n_batches = min(n_batches, max_batches)
        robust, clean, total = 0, 0, 0
        rob_masks = []
        for i in range(n_batches):
            bx = jnp.asarray(xs[i * bs : (i + 1) * bs])
            by = jnp.asarray(ys[i * bs : (i + 1) * bs])
            key, k = jax.random.split(key)
            _, rob = suite.run(bx, by, k)
            pred = jnp.argmax(logits_fn(bx), -1)
            clean += int(jnp.sum(pred == by))
            robust += int(jnp.sum(rob))
            total += len(bx)
            rob_masks.append(np.asarray(rob))
        return {
            # per-image audit: consistency checks (certified ⊆ robust) must
            # compare on the SAME image subset, not aggregate rates
            "robust_idx": np.nonzero(np.concatenate(rob_masks))[0].tolist(),
            "test_error_clean": 1.0 - clean / total,
            "test_error_adv": 1.0 - robust / total,
            "n_images": total,
        }

    def evaluate(self, params, key, split: str = "val", max_batches=None,
                 scale_nominal=None):
        if scale_nominal is None:
            scale_nominal = self._phase_scale_nominal
        xs = getattr(self.ds, f"{split}_x")
        ys = getattr(self.ds, f"{split}_y")
        bs = self.cfg.val_batch_size
        totals, count = None, 0
        # ceil-divide so the tail batch is seen (floor dropped up to bs-1
        # images from every validation pass); per-batch means are weighted
        # by batch size so the unequal tail doesn't skew the average.
        n_batches = max(1, -(-len(xs) // bs))
        if max_batches:
            n_batches = min(n_batches, max_batches)
        for i in range(n_batches):
            bx = jnp.asarray(xs[i * bs : (i + 1) * bs])
            by = jnp.asarray(ys[i * bs : (i + 1) * bs])
            key, k = jax.random.split(key)
            m = self._eval_step(params, k, bx, by,
                                scale_nominal=bool(scale_nominal))
            w = len(bx)
            m = {k_: float(v) * w for k_, v in m.items()}
            totals = m if totals is None else {
                k_: totals[k_] + m[k_] for k_ in m
            }
            count += w
        return {k_: v / count for k_, v in totals.items()}
