"""Command-line interface — the four reference entry points plus grid/segway.

Usage (hydra-compatible override spelling):
  python -m fiode_tpu train          --config-name cifar_train [k=v ...]
  python -m fiode_tpu sample-grid    --config-name cifar_certify ++T=40 [--out grid.pkl]
  python -m fiode_tpu certify-crown  --config-name cifar_certify --run-dir RUN [k=v ...]
  python -m fiode_tpu certify-lipschitz --config-name cifar_certify --run-dir RUN
    (++mesh_shape=[n_img,n_cell] shards certification over a 2-D device
     mesh; a single int shards the cell axis over a 1-D mesh;
     ++refine_rounds=N turns on BaB cell refinement of clean-but-
     uncertified images after the sweep: crown boxes via verify/refine.py
     with ++refine_alpha_iters=K for an alpha-CROWN box evaluator, the
     lipschitz grid-gap slack via verify/refine_lips.py)
  python -m fiode_tpu eval-autoattack   --config-name cifar_certify --run-dir RUN
  python -m fiode_tpu summarize-stream  RUN/certify_stream.jsonl [--out SUMMARY.json]
  python -m fiode_tpu data-check     [--dataset CIFAR10] [--data-root data]
    (verifies dropped-in real dataset files by structure + sha256 and
     prints the accuracy-parity commands — BASELINE.md "Blocked")
  python -m fiode_tpu segway-train   [--save PATH]
  python -m fiode_tpu segway-certify [--model PATH]

(reference: sl_pipeline.py CLI, robustness/sample_decision_boundary.py,
certify_crown.py, certify_lipschitz.py, eval_autoattack.py,
control/train_segway.py, control/certify_segway.py)
"""
from __future__ import annotations

import argparse
from .utils.config import compose

CONFIG_DIRS = {
    "train": "configs/classification",
    "certify": "configs/certify",
}


def _compose(args, kind):
    cfg_dir = args.config_dir or CONFIG_DIRS[kind]
    return compose(args.config_name, args.overrides, cfg_dir)


def main(argv=None):
    p = argparse.ArgumentParser(prog="fiode_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    def add(name, kind=None):
        sp = sub.add_parser(name)
        if kind:
            sp.add_argument("--config-name", required=True)
            sp.add_argument("--config-dir", default=None)
            sp.add_argument("overrides", nargs="*")
        return sp

    sp = add("train", "train")
    sp.add_argument("--run-dir", default=None)
    sp.add_argument("--epochs", type=int, default=None)
    sp.add_argument("--test-adv", action="store_true",
                    help="run AutoAttack apgd-ce/apgd-t at test time")
    sp.add_argument("--resume", action="store_true",
                    help="continue from the run dir's resume checkpoint "
                    "(full optimizer/PRNG state, written every eval)")
    sp.add_argument("--multihost", action="store_true",
                    help="initialize the JAX distributed runtime before "
                    "training (run the SAME command on every process with "
                    "JAX_COORDINATOR_ADDRESS/JAX_NUM_PROCESSES/"
                    "JAX_PROCESS_ID set — see parallel/multihost.py). The "
                    "data mesh then spans all hosts' devices; non-zero "
                    "processes log/checkpoint under RUN/proc<i>/")

    sp = add("sample-grid", "certify")
    sp.add_argument("--out", default=None)

    for name in ("certify-crown", "certify-lipschitz"):
        sp = add(name, "certify")
        sp.add_argument("--run-dir", required=True)
        sp.add_argument("--max-images", type=int, default=None)
        sp.add_argument("--image-batch", type=int, default=None,
                        help="stream the sweep in image batches with "
                        "running clean/certified counts "
                        "(reference certify_crown.py:161-166)")
        sp.add_argument("--stream-out", default=None,
                        help="append per-batch JSON lines here; summary "
                        "written to <path>.json")

    sp = sub.add_parser("summarize-stream")
    sp.add_argument("stream", help="certify_stream JSONL audit log")
    sp.add_argument("--out", default=None,
                    help="write merged summary JSON here (default: print)")

    sp = add("eval-autoattack", "certify")
    sp.add_argument("--run-dir", required=True)
    sp.add_argument("--max-images", type=int, default=None)
    sp.add_argument("--attacks", default="apgd-ce,apgd-t,fab-t,square")
    sp.add_argument("--out", default=None,
                    help="write a JSON artifact (knobs, robust_idx, "
                    "throughput) here")

    sp = sub.add_parser("data-check")
    sp.add_argument("--dataset", default="CIFAR10",
                    help="MNIST / FashionMNIST / CIFAR10 / CIFAR3")
    sp.add_argument("--data-root", default="data")

    sp = sub.add_parser("segway-train")
    sp.add_argument("--save", default="run_data/segway.pkl")
    sp.add_argument("--iters", type=int, default=300)
    sp.add_argument("--no-adv", action="store_true")
    sp.add_argument("--resume", action="store_true",
                    help="continue from SAVE.resume.pkl")

    sp = sub.add_parser("segway-certify")
    sp.add_argument("--model", default="run_data/segway.pkl")
    sp.add_argument("--r", type=float, default=0.01)
    sp.add_argument("--level", type=float, default=0.15)
    sp.add_argument("--plot-dir", default=None,
                    help="write Vdot-phase/streamline and 3-D trajectory "
                    "figures here (reference certify_segway.py:69-139)")

    args = p.parse_args(argv)
    from .utils.device import enable_compile_cache

    enable_compile_cache()

    if args.cmd == "train":
        run_dir = args.run_dir
        if args.multihost:
            # must precede every other JAX call so jax.devices() is global
            from .parallel.multihost import bootstrap_multihost

            idx, count = bootstrap_multihost()
            print(f"[multihost] process {idx}/{count}", flush=True)
            if idx and run_dir:
                # one writer per artifact: secondary processes keep their
                # own log/ckpt dirs instead of clobbering process 0's
                run_dir = f"{run_dir}/proc{idx}"
        from .experiment import run_train

        cfg = _compose(args, "train")
        run_train(cfg, run_dir=run_dir, epochs=args.epochs,
                  test_adv=args.test_adv, resume=args.resume)
    elif args.cmd == "sample-grid":
        from .experiment import run_sample_grid

        cfg = _compose(args, "certify")
        run_sample_grid(cfg, out_path=args.out)
    elif args.cmd in ("certify-crown", "certify-lipschitz"):
        from .experiment import run_certify

        cfg = _compose(args, "certify")
        run_certify(
            cfg, method=args.cmd.split("-")[1], run_dir=args.run_dir,
            max_images=args.max_images, image_batch=args.image_batch,
            stream_out=args.stream_out,
        )
    elif args.cmd == "summarize-stream":
        import json

        from .verify.certify import summarize_stream

        summary = summarize_stream(args.stream, out_path=args.out)
        print(json.dumps(summary, indent=2))
    elif args.cmd == "eval-autoattack":
        from .experiment import run_autoattack

        cfg = _compose(args, "certify")
        run_autoattack(
            cfg, run_dir=args.run_dir, max_images=args.max_images,
            attacks=tuple(
                a.strip() for a in args.attacks.split(",") if a.strip()
            ),
            out_path=args.out,
        )
    elif args.cmd == "data-check":
        import json
        import sys

        from .train.data import check_data_root

        report = check_data_root(args.dataset, args.data_root)
        print(json.dumps(report, indent=1))
        if report["ok"]:
            print(
                "\nReal {0} files verified. The accuracy-parity protocol "
                "(BASELINE.md) is now one command per stage:\n"
                "  python -m fiode_tpu train --config-name "
                "cifar_train.yaml --run-dir run_data/real "
                "++data_root={1}\n"
                "  python -m fiode_tpu certify-crown --config-name "
                "cifar_certify.yaml --run-dir run_data/real "
                "++data_root={1} --image-batch 16 --stream-out "
                "run_data/real/certify_stream.jsonl\n"
                "  python -m fiode_tpu eval-autoattack --config-name "
                "cifar_certify.yaml --run-dir run_data/real "
                "++data_root={1} --out run_data/real/autoattack.json"
                .format(args.dataset, args.data_root))
        else:
            print("\nNOT READY: " + "; ".join(report["errors"]),
                  file=sys.stderr)
            sys.exit(1)
    elif args.cmd == "segway-train":
        from .control.train_segway import SegwayTrainConfig, train_segway

        cfg = SegwayTrainConfig(
            adv_train=not args.no_adv,
            fit_lqr_iters=args.iters, barrier_iters=args.iters,
        )
        train_segway(cfg, save_path=args.save, resume=args.resume)
    elif args.cmd == "segway-certify":
        from .control.certify_segway import certify_segway

        certify_segway(args.model, r=args.r, level=args.level,
                       plot_dir=args.plot_dir)


if __name__ == "__main__":
    main()
