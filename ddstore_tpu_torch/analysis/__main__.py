"""CLI: ``python -m ddstore_tpu_torch.analysis [--package ddstore_tpu]``.

Exit 0 when every finding is pinned in the package's
``analysis/baseline.json``; exit 1 on any NEW finding (printed with
file:line anchors). This is the same pass
``tests/test_torch_static_analysis.py`` runs in tier-1, so a tier-1 lint
failure reproduces locally with one command.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import (PACKAGE, baseline_entry, baseline_path, load_baseline,
               repo_root, run_against_baseline)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ddstore_tpu_torch.analysis",
        description="ddlint: repo-native concurrency & contract "
                    "analyzer (lock discipline, capi/binding drift, "
                    "knob registry, tier1 skip paths)")
    ap.add_argument("--repo", default="", help="checkout root "
                    "(default: auto-detected from the package path)")
    ap.add_argument("--package", default=PACKAGE, help="the package "
                    "whose tree is analyzed (default: %(default)s)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="pin every CURRENT finding into "
                    "baseline.json with reason=TODO (then edit the "
                    "reasons; new findings fail until pinned)")
    ap.add_argument("--verbose", action="store_true",
                    help="also list baselined findings and stale "
                    "baseline entries")
    args = ap.parse_args(argv)

    t0 = time.monotonic()
    new, stale, all_findings = run_against_baseline(args.repo, args.package)
    dt = time.monotonic() - t0
    bpath = baseline_path(args.repo, args.package)

    if args.write_baseline:
        baseline = load_baseline(bpath)
        entries = []
        for f in all_findings:
            prev = baseline.get(f.key())
            reason = prev["reason"] if prev and "reason" in prev \
                else "TODO: justify or fix"
            entries.append(baseline_entry(f, reason))
        with open(bpath, "w") as fh:
            json.dump({"findings": entries}, fh, indent=2,
                      sort_keys=True)
            fh.write("\n")
        print(f"{bpath}: pinned {len(entries)} finding(s)")
        return 0

    repo = args.repo or repo_root()
    print(f"ddlint: {len(all_findings)} finding(s) in {repo} "
          f"({dt:.2f}s); {len(all_findings) - len(new)} baselined, "
          f"{len(new)} new, {len(stale)} stale baseline entr"
          f"{'y' if len(stale) == 1 else 'ies'}")
    if args.verbose:
        baseline = load_baseline(bpath)
        for f in all_findings:
            if f.key() in baseline:
                print(f"  (baselined: {baseline[f.key()].get('reason')})")
                print("  " + f.render().replace("\n", "\n  "))
    for e in stale:
        print(f"  stale baseline entry (no longer fires — remove it): "
              f"{e['category']}:{e['file']}:{e['symbol']}")
    if new:
        print(f"\n{len(new)} NEW finding(s):")
        for f in new:
            print(f.render())
        print(f"\nFix the finding, or pin it in {bpath} with a reason "
              "(see README \"Static analysis\").")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
