"""Chaos campaign entry on the port: seeded random gray-failure scenarios
with invariant checking and automatic shrinking
(``repro_torch.netsim.chaos``), the port of the reference's
``benchmarks/chaos_campaign.py`` CLI.

    # fixed-seed campaign over the fault archetype space (exit 1 on any
    # invariant violation, after shrinking and writing the repro artifact)
    python -m repro_torch.bench.chaos_campaign --seed 42 --budget 120 --artifacts /tmp/chaos

    # re-run a shrunk repro artifact; exits 0 only if the violation
    # reproduces and the run is bit-identical to the recorded digest
    python -m repro_torch.bench.chaos_campaign --replay /tmp/chaos/chaos_repro_*.json

    # prove the checker has teeth: the known-bad fixture (ecmp under a
    # permanent half-fabric outage) must violate, shrink and replay
    python -m repro_torch.bench.chaos_campaign --known-bad --artifacts /tmp/chaos

Campaigns are deterministic in ``--seed``: the same seed generates the same
scenarios, faults and mid-run injection points.  Runs on the card unless
``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.netsim.chaos import REPRO_CMD, ChaosCampaign, known_bad_scenario


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=42,
                    help="campaign seed (scenario generation is a pure function of it)")
    ap.add_argument("--budget", type=float, default=180.0,
                    help="wall-clock budget in seconds (at least --min-scenarios run "
                         "regardless)")
    ap.add_argument("--min-scenarios", type=int, default=5,
                    help="scenarios to run even past budget (the default covers every "
                         "fault archetype once)")
    ap.add_argument("--max-scenarios", type=int, default=None,
                    help="hard cap on scenario count")
    ap.add_argument("--lb", default="reps", help="load balancer under test")
    ap.add_argument("--artifacts", default=None,
                    help="directory for shrunk repro artifacts")
    ap.add_argument("--replay", default=None, metavar="ARTIFACT",
                    help="re-run a repro artifact instead of a campaign; exit 0 iff the "
                         "violation reproduces bit-exactly")
    ap.add_argument("--known-bad", action="store_true",
                    help="run the known-bad fixture through the full violation -> shrink "
                         "-> replay cycle (exit 0 iff every step behaves)")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--out", default=None, help="write the report JSON here")
    args = ap.parse_args(argv)

    campaign = ChaosCampaign(
        seed=args.seed, budget_s=args.budget,
        min_scenarios=args.min_scenarios, max_scenarios=args.max_scenarios,
        lb=args.lb, device=args.device,
    )

    if args.replay:
        with open(args.replay) as fh:
            artifact = json.load(fh)
        print(f"replaying {args.replay} (expected digest {artifact['record_digest'][:12]})")
        violations, bit_exact = campaign.replay(artifact)
        for v in violations:
            print(f"  {v.invariant} @ {v.cell} t={v.tick}: {v.detail}")
        print(f"violations={len(violations)} bit_exact={bit_exact}")
        return 0 if (violations and bit_exact) else 1

    if args.known_bad:
        scenario = known_bad_scenario()
        violations, _ = campaign.run_scenario(scenario)
        if not violations:
            print("FAIL: known-bad fixture produced no violation — the invariant checker "
                  "has lost its teeth")
            return 1
        print(f"known-bad fixture violated as expected: "
              f"{sorted({v.invariant for v in violations})}")
        minimal, mv, mrec = campaign.shrink(scenario)
        artifact = campaign.make_artifact(minimal, mv, mrec)
        print(f"shrunk to {len(minimal.faults)} fault(s), {minimal.n_conns or 'all'} conns, "
              f"{minimal.ticks} ticks, {minimal.msg_pkts} pkts")
        if args.artifacts:
            os.makedirs(args.artifacts, exist_ok=True)
            path = os.path.join(args.artifacts, "chaos_known_bad.json")
            with open(path, "w") as fh:
                json.dump(artifact, fh, indent=2, sort_keys=True)
            print(f"artifact written to {path}")
        rv, bit_exact = campaign.replay(artifact)
        print(f"replay: violations={len(rv)} bit_exact={bit_exact}")
        return 0 if (rv and bit_exact) else 1

    report = campaign.run(artifact_dir=args.artifacts)
    blob = json.dumps(report, indent=1, sort_keys=True)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(blob + "\n")
    print(f"scenarios={len(report['scenarios'])} violations={len(report['violations'])} "
          f"elapsed={report['elapsed_s']}s")
    for v in report["violations"]:
        print(f"  {v['invariant']} @ {v['cell']} t={v['tick']}: {v['detail']}")
    if report.get("artifact_path"):
        print(f"minimal repro: {report['artifact_path']}")
        print(f"replay with: {REPRO_CMD} --replay {report['artifact_path']}")
    return 1 if report["violations"] else 0


if __name__ == "__main__":
    sys.exit(main())
