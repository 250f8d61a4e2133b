"""A real shrink, port against JAX on the CPU, and the port's known-bad CLI.

The reference's own shrink test starts from a seedling that no longer
violates under this JAX (tests/test_torch_chaos.py holds that), so shrink
is exercised here on one that violates under both packages: the known-bad
fixture at 640 ticks cut to 4 connections of 8 packets and two spines, the
one those connections use first and one they never use (so that the loop
meets a candidate that does not violate).  Every scenario the greedy loop
runs, in order, and its violations and record digest equal JAX's; the
minimal scenario's artifact replays bit-exactly.  Then ``python -m
repro_torch.bench.chaos_campaign --known-bad`` on that minimal fixture
violates, shrinks (to itself), writes its artifact and replays."""
import dataclasses
import json

from chaos_parity import assert_outcome_equal, campaigns, tchaos, to_port
from repro.netsim import chaos as jchaos


def _recording(campaign):
    """Wrap ``run_scenario`` to log every scenario the campaign runs."""
    steps, run = [], campaign.run_scenario

    def logged(s):
        out = run(s)
        steps.append((s, out))
        return out

    campaign.run_scenario = logged
    return steps


def test_shrink_steps_equal_reference_and_artifact_replays(tmp_path):
    jc, tc = campaigns(seed=1, msg_pkts=None, small=False)
    seedling = dataclasses.replace(
        jchaos.known_bad_scenario(ticks=640, chunk=160), n_conns=4, msg_pkts=8,
        faults=tuple(jchaos.ChaosFault("spine_down", tor=0, spine=sp, start=8,
                                       end=jchaos.failures.FOREVER) for sp in (1, 0)),
    )
    jsteps, tsteps = _recording(jc), _recording(tc)
    jmin, jv, jrec = jc.shrink(seedling)
    tmin, tv, trec = tc.shrink(to_port(seedling))
    # the seedling; spine 0 alone (no violation); spine 1 alone; 320 ticks; 4 packets
    assert len(tsteps) == len(jsteps) == 5
    assert [bool(out[0]) for _, out in tsteps] == [True, False, True, True, True]
    for i, ((js, jout), (ts, tout)) in enumerate(zip(jsteps, tsteps)):
        assert ts.to_dict() == js.to_dict(), i
        assert_outcome_equal(jout, tout, f"shrink step {i}")
    assert tmin.to_dict() == jmin.to_dict()
    assert_outcome_equal((jv, jrec), (tv, trec), "minimal")
    # the loop made progress: fewer faults, a shorter horizon, smaller messages
    assert [f.spine for f in tmin.faults] == [1] and tmin.ticks == 320 and tmin.msg_pkts == 4
    assert {v.invariant for v in tv} == {"completion"}
    # the artifact replays bit-exactly, and names the port's CLI
    artifact = tc.make_artifact(tmin, tv, trec)
    assert artifact["record_digest"] == jc.make_artifact(jmin, jv, jrec)["record_digest"]
    path = tmp_path / "repro.json"
    path.write_text(json.dumps(artifact, sort_keys=True))
    loaded = json.loads(path.read_text())
    assert "repro_torch.bench.chaos_campaign" in loaded["repro"]
    rv, bit_exact = tc.replay(loaded)
    assert rv and bit_exact


def test_known_bad_cli_violates_shrinks_and_replays(tmp_path, capsys, monkeypatch):
    """The CLI's whole cycle on the minimal fixture of the test above (at full
    size it is run on the card)."""
    from repro_torch.bench import chaos_campaign

    cut = dataclasses.replace(
        tchaos.known_bad_scenario(ticks=320), n_conns=4, msg_pkts=4,
        faults=(tchaos.ChaosFault("spine_down", tor=0, spine=1, start=8,
                                  end=tchaos.failures.FOREVER),),
    )
    monkeypatch.setattr(chaos_campaign, "known_bad_scenario", lambda: cut)
    code = chaos_campaign.main(["--known-bad", "--artifacts", str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert code == 0, out
    assert "known-bad fixture violated as expected: ['completion']" in out
    assert "replay: violations=1 bit_exact=True" in out
    artifact = json.loads((tmp_path / "chaos_known_bad.json").read_text())
    minimal = tchaos.ChaosScenario.from_dict(artifact["scenario"])
    assert len(minimal.faults) == 1 and minimal.n_conns == 4 and minimal.msg_pkts == 4
