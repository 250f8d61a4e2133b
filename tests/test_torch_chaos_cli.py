"""The port's chaos CLI (``python -m repro_torch.bench.chaos_campaign``):
``--replay`` of an artifact the port wrote reproduces its violation
bit-exactly (and a wrong digest fails), and a one-scenario campaign
(``--max-scenarios 1``) writes the reference CLI's report, field for field
but the wall clock."""
import dataclasses
import json

from chaos_parity import campaigns, tchaos


def test_replay_cli_reproduces_artifact_bit_exactly(tmp_path, capsys):
    from repro_torch.bench import chaos_campaign

    _, tc = campaigns(seed=1, msg_pkts=None, small=False)
    s = tchaos.ChaosScenario(
        name="chaos/known_bad/ecmp_half_fabric", seed=7, lb="ecmp", msg_pkts=4, ticks=320,
        chunk=160, n_conns=4,
        faults=(tchaos.ChaosFault("spine_down", tor=0, spine=1, start=8,
                                  end=tchaos.failures.FOREVER),),
    )
    violations, record = tc.run_scenario(s)
    assert violations
    path = tmp_path / "repro.json"
    artifact = tc.make_artifact(s, violations, record)
    path.write_text(json.dumps(artifact, indent=2, sort_keys=True))
    assert chaos_campaign.main(["--replay", str(path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "violations=1 bit_exact=True" in out
    artifact["record_digest"] = "0" * 64
    path.write_text(json.dumps(artifact))
    assert chaos_campaign.main(["--replay", str(path), "--device", "cpu"]) == 1
    assert "bit_exact=False" in capsys.readouterr().out


def test_one_scenario_campaign_report_equals_reference_cli(tmp_path, capsys, monkeypatch):
    """The CLI's campaign loop, report and ``--out`` in both packages, on
    scenario 0 (a link down over ticks 26-106, with its kill/resume check)
    cut to 640 ticks of 24-packet messages, past the retransmits."""
    from benchmarks import chaos_campaign as jcli
    from repro.netsim import chaos as jchaos
    from repro_torch.bench import chaos_campaign as tcli

    for cls in (jchaos.ChaosCampaign, tchaos.ChaosCampaign):
        monkeypatch.setattr(cls, "generate", lambda self, i, g=cls.generate: dataclasses.replace(
            g(self, i), ticks=640, msg_pkts=24))

    args = ["--seed", "11", "--max-scenarios", "1", "--budget", "0"]
    assert tcli.main([*args, "--device", "cpu", "--out", str(tmp_path / "t.json")]) == 0
    assert jcli.main([*args, "--out", str(tmp_path / "j.json")]) == 0
    out = capsys.readouterr().out
    assert "scenarios=1 violations=0" in out
    t, j = (json.loads((tmp_path / f"{k}.json").read_text()) for k in "tj")
    assert t.pop("elapsed_s") >= 0 and j.pop("elapsed_s") >= 0
    assert t == j
    assert t["n_scenarios"] == 1 and t["scenarios"][0]["faults"] == ["link_down"]
