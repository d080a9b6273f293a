"""Per-tier accounting of the BaB refinement campaign.

Folds the base CROWN sweep summary and every refinement pass artifact
(``refine_full*.json`` / ``*_stream.jsonl``) into one table: for each
difficulty tier (by the image's plain-CROWN violated-cell count) how many
images were certified by which pass, and what the survivors' blocking
give-up reasons are.  This is the audit view of the claim "capacity
overflow is a scheduling event, not a verdict" — the reference abandons
an image at its first positive-bound cell
(robustness/certify_crown.py:149-153), so every row here is capability
beyond it.

Usage:
  python examples/refine_accounting.py [--run-dir run_data/certified_full]
      [--out refine_accounting.json]

Pure host-side JSON folding — no device work, safe to run while a
refinement pass holds the device.
"""
import argparse
import json
import sys
from pathlib import Path

TIERS = [
    (0, 1 << 20, "<=1M violated"),
    (1 << 20, 4_000_000, "1-4M violated"),
    (4_000_000, 16_000_000, "4-16M violated"),
    (16_000_000, None, ">16M violated"),
]


def tier_of(violated):
    if violated is None or violated < 0:
        return "unknown (exceeded collect cap)"
    for lo, hi, name in TIERS:
        if violated >= lo and (hi is None or violated < hi):
            return name
    raise AssertionError(violated)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--run-dir", default="run_data/certified_full")
    ap.add_argument("--summary", default="certify_stream_full.summary.json")
    ap.add_argument("--out", default="refine_accounting.json")
    args = ap.parse_args(argv)

    run_dir = Path(args.run_dir)
    summary = json.loads((run_dir / args.summary).read_text())
    n = int(summary["n_images"])
    base = set(summary["certified_idx"])

    # per-image: latest verdict wins per pass ordering; remember the best
    # violated count ever measured (later passes re-measure under bigger
    # collect caps, replacing -1 "exceeded cap" with a real count)
    passes = []
    for p in sorted(run_dir.glob("refine_full*.json")):
        if p.name.endswith(".summary.json"):
            continue
        passes.append((p.stem, json.loads(p.read_text())))
    streams = sorted(run_dir.glob("refine_full*_stream.jsonl"))

    cert_by = {}          # image -> pass name that first certified it
    violated = {}         # image -> best-known violated count
    last_fail = {}        # image -> (pass, gave_up) for survivors
    for name, art in passes:
        for rec in art.get("stats", []):
            img = int(rec["image"])
            v = rec.get("base_violated", -1)
            if v >= 0 and violated.get(img, -1) < v:
                violated[img] = v
            if rec.get("certified") and img not in cert_by and img not in base:
                cert_by[img] = name
            elif not rec.get("certified"):
                last_fail[img] = (name, rec.get("gave_up", ""))
    for sp in streams:
        pname = sp.name.replace("_stream.jsonl", "")
        for ln, line in enumerate(sp.read_text().splitlines(), 1):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                print(f"warning: {sp}:{ln} malformed, skipped",
                      file=sys.stderr)
                continue
            img = int(rec["image"])
            v = rec.get("base_violated", -1)
            if v >= 0 and violated.get(img, -1) < v:
                violated[img] = v
            if rec.get("certified") and img not in base:
                cert_by.setdefault(img, pname)
            elif not rec.get("certified"):
                last_fail[img] = (pname, rec.get("gave_up", ""))

    certified = base | set(cert_by)
    survivors = sorted(set(range(n)) - certified)

    # exact-witness audit (examples/refute_witnesses.py): survivors whose
    # exact Vdot + kappa is positive at a lattice point are REFUTED — no
    # sound box method can certify them at this protocol — so the
    # completeness denominator for refinement is n - len(refuted)
    refuted, margins = set(), {}
    wit_path = run_dir / "exact_witnesses.json"
    if wit_path.exists():
        wit = json.loads(wit_path.read_text())
        refuted = set(wit["refuted"]) & set(survivors)
        margins = {r["image"]: r["exact_margin"]
                   for r in wit["witnesses"]}

    tiers = {}
    for img in sorted(set(cert_by) | set(survivors)):
        t = tier_of(violated.get(img))
        row = tiers.setdefault(
            t, {"recovered": 0, "recovered_by": {}, "open": 0,
                "open_blockers": {}, "open_images": []})
        if img in cert_by:
            row["recovered"] += 1
            row["recovered_by"][cert_by[img]] = (
                row["recovered_by"].get(cert_by[img], 0) + 1)
        else:
            row["open"] += 1
            row["open_images"].append(img)
            blocker = ("refuted_exact_witness" if img in refuted else
                       last_fail.get(img, ("never_attempted", ""))[1] or
                       ("never_attempted" if img not in last_fail
                        else "unknown"))
            row["open_blockers"][blocker] = (
                row["open_blockers"].get(blocker, 0) + 1)

    out = {
        "n_images": n,
        "base_certified": len(base),
        "certified": len(certified),
        "certified_acc": len(certified) / n,
        "recovered": len(cert_by),
        "open": len(survivors),
        "open_images": survivors,
        "tiers": tiers,
    }
    if wit_path.exists():
        tractable = sorted(set(survivors) - refuted)
        out["refuted_exact_witness"] = sorted(refuted)
        out["tractable_open"] = tractable
        out["tractable_margins"] = {
            str(i): margins[i] for i in tractable if i in margins
        }
        denom = n - len(refuted)
        out["certifiable_ceiling"] = denom
        out["completeness_vs_ceiling"] = len(certified) / denom
    (run_dir / args.out).write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps({k: out[k] for k in
                      ("base_certified", "certified", "recovered", "open")}))
    for t, row in tiers.items():
        print(f"  {t}: recovered={row['recovered']} {row['recovered_by']} "
              f"open={row['open']} blockers={row['open_blockers']}")
    return out


if __name__ == "__main__":
    main()
