"""The port's chaos engine (repro_torch.netsim.chaos) on the CPU against
the reference's (repro.netsim.chaos), mirroring tests/test_chaos.py: scenario
generation and its JSON round trip, REPS surviving a generated scenario with
kill/resume parity, the reference's shrink seedling (no violation under
this JAX, so the port must give none either), and the monitor flagging a
corrupted carry.  Every run's violation list, record and record digest
equal JAX's.  The known-bad fixture, its REPS control and the tight
recovery bound are in tests/test_torch_chaos_teeth.py, a real shrink and
the CLI in tests/test_torch_chaos_campaign.py."""
import dataclasses
import json

import numpy as np

from chaos_parity import campaigns, run_both, tchaos, to_port
from repro.netsim import chaos as jchaos


def test_generate_equals_reference_and_covers_archetypes():
    jc, tc = campaigns()
    a = [tc.generate(i) for i in range(len(tchaos.ARCHETYPES))]
    assert a == [tc.generate(i) for i in range(len(tchaos.ARCHETYPES))]
    assert [s.to_dict() for s in a] == [jc.generate(i).to_dict() for i in range(len(a))]
    primaries = [s.faults[0].archetype for s in a]
    assert primaries[:4] == ["link_down", "link_degraded", "link_flapping", "gray_loss"]
    assert primaries[4] in ("switch_down", "switch_degraded", "spine_down")
    assert tchaos.ARCHETYPES == jchaos.ARCHETYPES
    # the chip's scenarios: link flapping plus a degraded link, gray loss 0.2424
    assert [f.archetype for f in a[2].faults] == ["link_flapping", "link_degraded"]
    assert a[3].faults[0].rate == 0.2424


def test_scenario_round_trips_through_json():
    s = tchaos.known_bad_scenario()
    blob = json.dumps(s.to_dict(), sort_keys=True)
    assert tchaos.ChaosScenario.from_dict(json.loads(blob)) == s
    assert blob == json.dumps(jchaos.known_bad_scenario().to_dict(), sort_keys=True)


def test_reps_survives_generated_scenario_with_resume_parity():
    jc, tc = campaigns()
    s = jc.generate(0)  # resume_check=True: includes kill/resume parity
    assert s.resume_check
    violations, record = run_both(jc, tc, s)
    assert violations == []
    assert record["summaries"][s.name][0]["completed"] == 32


def test_reference_shrink_seedling_gives_no_violation_as_in_jax():
    """tests/test_chaos.py's shrink seedling gives no violation under this
    JAX (that test fails at its first assertion); the port gives the same
    empty list and the same record."""
    jc, tc = campaigns(seed=1, msg_pkts=None, small=False)
    seedling = dataclasses.replace(
        jchaos.known_bad_scenario(ticks=320, chunk=160),
        faults=(jchaos.ChaosFault("spine_down", tor=0, spine=3, start=8,
                                  end=jchaos.failures.FOREVER),),
        msg_pkts=6, n_conns=8,
    )
    violations, _ = run_both(jc, tc, seedling)
    assert violations == []


def test_monitor_flags_corrupted_carry():
    """A deliberately corrupted state: conservation and monotone fire, in
    the port as in JAX (the checker is not outcome-only)."""
    jc, tc = campaigns()
    s = dataclasses.replace(jc.generate(0), resume_check=False, faults=(),
                            name="chaos/corrupt")
    jrun, trun = jc._runner(s), tc._runner(to_port(s))
    inv = dict(no_progress_window=10**9)
    jmon = jchaos.ChaosInvariants(**inv).monitor(jrun)
    tmon = tchaos.ChaosInvariants(**inv).monitor(trun)
    jrun.advance(s.chunk)
    trun.advance(s.chunk)
    assert tmon.boundary() == [] and jmon.boundary() == []
    # the sentinel slots are sliced off: the reference's shapes
    st = tmon._states(0)
    sim = trun.engine.buckets[0].program.sim
    assert st.pkt_state.shape[-1] == sim.NP and st.c_rcv.shape[1] == s.workload(tc.cfg).n_conns
    # corrupt: free-list count off by one, and a stats counter rewound
    states, tel = jrun.carries[0]
    jrun.carries[0] = (states._replace(fl_count=states.fl_count + 1,
                                       s_stats=states.s_stats.at[:, :].set(0)), tel)
    states, tel = trun.carries[0]
    trun.carries[0] = (states.replace(fl_count=states.fl_count + 1,
                                      s_stats=states.s_stats * 0), tel)
    jv, tv = jmon.boundary(), tmon.boundary()
    assert [v.to_dict() for v in tv] == [v.to_dict() for v in jv]
    got = {v.invariant for v in tv}
    assert {"conservation", "monotone"} <= got
    # a delivered counter off its bitmap fires delivered_bitmap
    states, tel = trun.carries[0]
    trun.carries[0] = (states.replace(c_delivered=states.c_delivered + 1), tel)
    assert "delivered_bitmap" in {v.invariant for v in tmon.boundary()}
    assert np.array_equal(tmon._last_progress[0], np.asarray(jmon._last_progress[0]))
