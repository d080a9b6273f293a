"""Record the certified ⊆ robust inclusion between committed artifacts.

A sound certificate must never certify an image an empirical attack can
break: at matching protocol knobs (same eps / norm / attack-time horizon),
``certified_idx ⊆ robust_idx`` must hold exactly.  This folds the current
certified set (base CROWN sweep + every refinement pass, i.e. the same
union refine_accounting.py computes) against an eval-autoattack artifact
and writes a small JSON verdict with any violations enumerated — the
consistency check the reference runs by eye between certify_crown.py and
eval_autoattack.py outputs (robustness/eval_autoattack.py:79-89 saves the
robust indices for exactly this purpose).

Usage:
  python examples/inclusion_check.py \
      [--run-dir run_data/certified_full] \
      [--attack autoattack_full_standard_512_tmax01.json] \
      [--out inclusion_tmax01.json]

Host-side JSON folding only — safe to run while a device job is live.
"""
import argparse
import json
from pathlib import Path

from refine_accounting import main as accounting_main


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--run-dir", default="run_data/certified_full")
    ap.add_argument("--summary", default="certify_stream_full.summary.json")
    ap.add_argument("--attack",
                    default="autoattack_full_standard_512_tmax01.json")
    ap.add_argument("--out", default=None,
                    help="default: inclusion_<attack-stem-tail>.json")
    args = ap.parse_args(argv)
    run_dir = Path(args.run_dir)

    # the certified set = accounting's base ∪ recovered (recomputed fresh
    # so a just-finished refinement pass is folded in)
    acc = accounting_main(["--run-dir", str(run_dir),
                           "--summary", args.summary])
    n = acc["n_images"]
    certified = set(range(n)) - set(acc["open_images"])

    atk = json.loads((run_dir / args.attack).read_text())
    if atk["n_images"] < n:
        raise SystemExit(
            f"attack artifact covers {atk['n_images']} < {n} images; "
            "inclusion over the full set needs a full-set attack run"
        )
    robust = set(atk["robust_idx"])
    violations = sorted(certified - robust)

    out = {
        "attack_artifact": args.attack,
        "attack_t_max": atk.get("t_max"),
        "attack_eps": atk.get("eps"),
        "n_images": n,
        "certified": len(certified),
        "robust": len(robust & set(range(n))),
        "inclusion_holds": not violations,
        "violations": violations,
    }
    out_name = args.out or (
        "inclusion_" + Path(args.attack).stem.rsplit("_", 1)[-1] + ".json"
    )
    (run_dir / out_name).write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps(out if not violations else
                     {**out, "violations": violations}))
    if violations:
        raise SystemExit(2)
    return out


if __name__ == "__main__":
    main()
