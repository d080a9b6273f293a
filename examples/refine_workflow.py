"""BaB-refine the uncertified images of a completed CROWN sweep.

Reads a ``certify_stream`` summary (the committed full-test-set sweep) for
the already-certified set, runs the branch-and-bound cell refinement
(fiode_tpu/verify/refine.py) over every clean-but-uncertified image, and
writes ``<run-dir>/refine_full.json`` with per-image stats and the upgraded
certified set.  The refinement re-sweeps each candidate image's full grid
itself (it does not trust the summary's verdicts), so the output is a
self-contained certificate for every image it flips.

Usage:
  python examples/refine_workflow.py [--run-dir run_data/certified_full]
      [--summary certify_stream_full.summary.json] [--end 512]
      [--rounds 40] [--out refine_full.json]

The reference has no counterpart: robustness/certify_crown.py:149-153
abandons an image at the first positive-bound cell.

Resumable: every processed image's verdict is appended to
``<out-stem>_stream.jsonl`` as it completes; re-running the same command
skips those images, so a killed run loses at most one image's work.
``seconds`` in the final JSON is this process's
wall time; per-image times in ``stats`` cover the whole run.
"""
import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--run-dir", default="run_data/certified_full")
    ap.add_argument("--summary", default="certify_stream_full.summary.json")
    ap.add_argument("--config-name", default="cifar_certify.yaml")
    ap.add_argument("overrides", nargs="*",
                    help="hydra-style ++key=value overrides (e.g. ++T=6 "
                    "for a small-lattice smoke drive)")
    ap.add_argument("--end", type=int, default=512)
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--collect-cap", type=int, default=4_000_000)
    ap.add_argument("--box-budget", type=int, default=64_000_000)
    ap.add_argument("--frontier-cap", type=int, default=1 << 20)
    ap.add_argument("--alpha-iters", type=int, default=0,
                    help="alpha-CROWN slope-optimization iterations in the "
                    "BaB box evaluator (0 = plain CROWN). MEASURED: DOES "
                    "NOT PAY on this workload — 0 images recovered at a "
                    "several-fold cost per box "
                    "(run_data/certified_full/ALPHA_CROWN.json); keep 0 "
                    "unless re-measuring on a different model")
    ap.add_argument("--lips-box", action="store_true",
                    help="evaluate every cell/box under min(CROWN bound, "
                    "exact-center + local-Lipschitz bound) — never looser "
                    "than plain CROWN, ~+1 exact forward per box; shrinks "
                    "the collected violated set for collect_cap-tier "
                    "images (verify/refine.py _kernels docstring)")
    ap.add_argument("--device-cap", type=int, default=1 << 25,
                    help="device-resident BaB frontier capacity (rows); "
                    "see verify/refine.py refine_uncertified for the "
                    "fused round's memory at 2^25 — larger frontiers are "
                    "host-partitioned "
                    "into independent sub-frontiers automatically")
    ap.add_argument("--image-seconds", type=float, default=None,
                    help="per-image wall-clock cap (gave_up=time_budget); "
                    "keeps a pass over an unknown-difficulty tail "
                    "schedulable — capped images retry under a bigger cap "
                    "via the budget-stamped resume")
    ap.add_argument("--images", default=None,
                    help="comma-separated test indices to refine (others "
                    "are skipped), PROCESSED IN THE GIVEN ORDER; lets a "
                    "pass schedule the winnable tier first (e.g. by "
                    "descending exact-witness margin, see "
                    "examples/refute_witnesses.py) instead of index order")
    ap.add_argument("--order-by-witness", nargs="?", metavar="WITNESS_JSON",
                    const="exact_witnesses.json", default="auto",
                    help="schedule the todo images by DESCENDING exact "
                    "margin from a refute_witnesses.py artifact (path "
                    "relative to --run-dir; default exact_witnesses.json), "
                    "skipping its refuted images entirely — no sound box "
                    "method can certify those at the protocol, so their "
                    "budget is pure waste (pass 5 burned 203M boxes on "
                    "refuted image 24 before this audit existed). Images "
                    "absent from the audit run after the audited ones, "
                    "index order. DEFAULT: auto-loads "
                    "<run-dir>/exact_witnesses.json when present")
    ap.add_argument("--no-witness-order", action="store_true",
                    help="disable the witness-audit default: plain index "
                    "order, refuted images NOT skipped")
    ap.add_argument("--chunk", type=int, default=8192)
    ap.add_argument("--superchunk", type=int, default=16)
    ap.add_argument("--out", default="refine_full.json")
    args = ap.parse_args()

    import jax.numpy as jnp

    from fiode_tpu.experiment import (
        _load_cfg_dataset,
        _restore_params,
        build_model,
    )
    from fiode_tpu.utils.config import compose
    from fiode_tpu.verify.certify import Certifier
    from fiode_tpu.verify.refine import RefineStats, refine_uncertified

    run_dir = Path(args.run_dir)
    summary = json.loads((run_dir / args.summary).read_text())
    # accept both summary shapes: summarize_stream's (index_min/index_max)
    # and certify_stream's own <out>.json (start_ind + n_images)
    idx_min = int(summary.get("index_min", summary.get("start_ind", 0)))
    idx_max = int(summary.get(
        "index_max", idx_min + int(summary["n_images"]) - 1
    ))
    if idx_min != 0:
        raise SystemExit(
            f"summary covers indices {idx_min}..{idx_max}; this driver "
            "refines test indices from 0 — re-run the sweep with "
            "++start_ind=0 or translate certified_idx yourself"
        )
    cfg = compose(args.config_name, args.overrides, "configs/certify")
    model = build_model(cfg)
    params = _restore_params(cfg, model, str(run_dir))
    ds = _load_cfg_dataset(cfg)
    end = min(args.end, idx_max + 1, len(ds.test_x))

    certified = np.zeros(end, bool)
    certified[[i for i in summary["certified_idx"] if i < end]] = True
    base_mask = certified.copy()
    base_certified = int(base_mask.sum())

    # resume: every processed image's verdict is streamed to a JSONL sidecar
    # so an interrupted run loses at most one image's work.  Budget
    # params are stamped into every record: a certified verdict is final
    # (sound under ANY budget) and always skipped, but a gave-up verdict is
    # only skipped when this run's budgets match the record's — re-running
    # with raised budgets (or a different bound, --alpha-iters) retries
    # exactly the images the old budgets failed on.
    budget_params = {
        "rounds": args.rounds,
        "collect_cap": args.collect_cap,
        "box_budget": args.box_budget,
        "frontier_cap": args.frontier_cap,
        "alpha_iters": args.alpha_iters,
        "lips_box": args.lips_box,
        "device_cap": args.device_cap,
        "image_seconds": args.image_seconds,
    }
    # the QP dual method changes bound values (exact vs 30-iter bisection
    # mu differ at the last ulp), so a gave-up under one method retries
    # under the other — certified verdicts stay final (both are sound)
    from fiode_tpu.ops.simplex_qp import qp_method_from_env
    if qp_method_from_env() != "bisect":
        budget_params["qp_method"] = qp_method_from_env()
    out_path = run_dir / args.out  # pathlib: absolute args.out wins
    stream_path = out_path.with_name(out_path.stem + "_stream.jsonl")
    streamed = {}
    if stream_path.exists():
        for ln, line in enumerate(stream_path.read_text().splitlines(), 1):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                # a process killed mid-append leaves a truncated final
                # line; degrade to re-refining that one image
                print(f"warning: {stream_path}:{ln} is malformed JSON "
                      "(truncated write?) — ignoring that record", flush=True)
                continue
            streamed[int(rec["image"])] = rec
    skip = np.zeros(end, bool)
    n_retry = 0
    for i, rec in streamed.items():
        if i >= end:
            continue
        if rec["certified"]:
            certified[i] = True
            skip[i] = True
        elif rec.get("params") == budget_params:
            skip[i] = True
        else:
            n_retry += 1  # gave up under different budgets: retry
    if streamed:
        print(f"resuming: {len(streamed)} streamed verdicts "
              f"({sum(r['certified'] for r in streamed.values())} certified"
              f"{f', retrying {n_retry} gave-ups under new budgets'
                 if n_retry else ''})",
              flush=True)

    order = None
    refuted_set = set()
    wit_arg = args.order_by_witness
    if args.no_witness_order:
        wit_arg = None
    elif wit_arg == "auto":
        wit_arg = ("exact_witnesses.json"
                   if (run_dir / "exact_witnesses.json").exists() else None)
    if wit_arg is not None:
        audit = json.loads((run_dir / wit_arg).read_text())
        ws = sorted(audit["witnesses"], key=lambda w: -w["exact_margin"])
        order = [int(w["image"]) for w in ws
                 if w["verdict"] == "tractable" and 0 <= int(w["image"]) < end]
        refuted_set = {int(w["image"]) for w in ws
                       if w["verdict"] == "refuted"
                       and 0 <= int(w["image"]) < end}
        if refuted_set:
            sel = np.zeros(end, bool)
            sel[sorted(refuted_set)] = True
            skip |= sel
            print(f"witness audit ({wit_arg}): skipping {len(refuted_set)} "
                  f"refuted images (uncertifiable at the protocol), "
                  f"scheduling {len(order)} tractable by descending margin",
                  flush=True)
    if args.images is not None:
        order = [int(s) for s in args.images.split(",") if s.strip()]
        out_of_range = sorted(i for i in order if not 0 <= i < end)
        if out_of_range:
            raise SystemExit(f"--images indices out of range: {out_of_range}")
        # an explicit listing overrides the witness refuted-skip: the user
        # asked for exactly these images, so un-skip any that the audit
        # refuted (resume skips for already-streamed verdicts still hold)
        overridden = sorted(set(order) & refuted_set)
        if overridden:
            resk = np.zeros(end, bool)
            for i, rec in streamed.items():
                if i < end and (rec["certified"]
                                or rec.get("params") == budget_params):
                    resk[i] = True
            for i in overridden:
                skip[i] = resk[i]
            print(f"--images overrides the witness refuted-skip for "
                  f"{overridden} (audit says these are uncertifiable at "
                  f"the protocol — budget will be spent anyway)", flush=True)
        sel = np.ones(end, bool)
        sel[order] = False
        skip |= sel

    cert = Certifier(
        model, params, T=int(cfg.get("T", 40)),
        eps_input=float(cfg.get("eps", 36 / 255)),
        scale_nominal=bool(cfg["module"]["dynamics"]["scale_nominal"]),
    )
    print(
        f"refining {int((~certified & ~skip).sum())} "
        f"uncertified of {end} images "
        f"(T={cert.T}, kappa={cert.kappa:.4f}, "
        f"precision={cert.matmul_precision}, rounds<={args.rounds}, "
        f"alpha_iters={args.alpha_iters})",
        flush=True,
    )
    t0 = time.time()

    def stream_image(s):
        with stream_path.open("a") as f:
            f.write(json.dumps(
                dataclasses.asdict(s) | {"params": budget_params}
            ) + "\n")

    new_cert, stats = refine_uncertified(
        cert, ds.test_x[:end], ds.test_y[:end], certified,
        max_rounds=args.rounds, collect_cap=args.collect_cap,
        box_budget=args.box_budget, frontier_cap=args.frontier_cap,
        alpha_iters=args.alpha_iters, lips_box=args.lips_box,
        device_cap=args.device_cap,
        image_seconds=args.image_seconds,
        chunk=args.chunk, superchunk=args.superchunk,
        progress_every=1, skip=skip, on_image=stream_image,
        order=order,
    )
    # fold resumed images' stats back in (fresh entries win on conflict);
    # tolerate older-generation records (missing fields get dataclass
    # defaults, the params stamp is workflow metadata, not a stat)
    fields = {f.name for f in dataclasses.fields(RefineStats)}
    fresh = {s.image for s in stats}
    stats = sorted(
        stats + [
            RefineStats(**{k: v for k, v in rec.items() if k in fields})
            for i, rec in streamed.items()
            if i < end and i not in fresh and skip[i]
        ],
        key=lambda s: s.image,
    )
    out = {
        "base_summary": args.summary,
        "n_images": end,
        "matmul_precision": cert.matmul_precision,
        "refine_rounds": args.rounds,
        "box_budget": args.box_budget,
        "collect_cap": args.collect_cap,
        "frontier_cap": args.frontier_cap,
        "alpha_iters": args.alpha_iters,
        "lips_box": args.lips_box,
        "base_certified": base_certified,
        "certified": int(new_cert.sum()),
        "recovered": int(new_cert.sum() - base_certified),
        "certified_acc": float(new_cert.mean()),
        "recovered_idx": sorted(
            np.nonzero(new_cert & ~base_mask)[0].tolist()
        ),
        "certified_idx": sorted(np.nonzero(new_cert)[0].tolist()),
        "seconds": time.time() - t0,
        "stats": [dataclasses.asdict(s) for s in stats],
    }
    out_path.write_text(json.dumps(out, indent=1))
    print(
        f"certified {out['base_certified']} -> {out['certified']} "
        f"(+{out['recovered']}) of {end} "
        f"[{out['certified_acc']:.4f}] in {out['seconds']:.0f}s "
        f"-> {out_path}",
        flush=True,
    )


if __name__ == "__main__":
    main()
