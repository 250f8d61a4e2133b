"""The port's model-config registry (repro_torch.configs), its per-layer
window schedule and its data pipeline (repro_torch.data) against the
reference's on the CPU, field for field and bit for bit."""
import dataclasses

import numpy as np
import pytest

from repro.configs import SHAPES as J_SHAPES
from repro.configs import all_configs as j_all
from repro.configs import applicable_shapes as j_applicable
from repro.configs import reduced as j_reduced
from repro.data import SyntheticLM as JSyntheticLM
from repro.models.transformer import window_schedule as j_window_schedule
from repro_torch.configs import SHAPES, all_configs, applicable_shapes, get_config, reduced
from repro_torch.data import SyntheticLM
from repro_torch.models.transformer import window_schedule

ARCHS = sorted(j_all())


def test_registry_lists_the_same_ten():
    assert sorted(all_configs()) == ARCHS and len(ARCHS) == 10
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in J_SHAPES.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_config_field_for_field(arch):
    want = j_all()[arch]
    for cfg, ref in ((get_config(arch), want), (reduced(get_config(arch)), j_reduced(want))):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
        assert cfg.param_count() == ref.param_count()
        assert cfg.active_param_count() == ref.active_param_count()
        assert cfg.pure_full_attention == ref.pure_full_attention
        assert cfg.q_per_kv == ref.q_per_kv
        assert applicable_shapes(cfg) == j_applicable(ref)


@pytest.mark.parametrize("seq_len", [64, 2304, 4096])
@pytest.mark.parametrize("arch", ARCHS)
def test_window_schedule_matches_reference(arch, seq_len):
    for cfg, ref in ((get_config(arch), j_all()[arch]),
                     (reduced(get_config(arch)), j_reduced(j_all()[arch]))):
        got = np.asarray(window_schedule(cfg, seq_len), np.int32)  # a list of ints
        want = np.asarray(j_window_schedule(ref, seq_len))
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_gemma3_window_schedule():
    ws = np.asarray(window_schedule(get_config("gemma3-4b"), 4096))
    assert (ws[5::6] > 4096).all()  # every 6th layer global
    local = np.ones(len(ws), bool)
    local[5::6] = False
    assert (ws[local] == 1024).all()


@pytest.mark.parametrize("case", [(128, 16, 8, 3, 4), (512, 32, 4, 1, 4), (2048, 17, 6, 7, 2)],
                         ids=lambda c: "-".join(map(str, c)))
def test_synthetic_lm_matches_reference(case):
    vocab, seq_len, batch, seed, branching = case
    got = SyntheticLM(vocab, seq_len, batch, seed=seed, branching=branching)
    want = JSyntheticLM(vocab, seq_len, batch, seed=seed, branching=branching)
    np.testing.assert_array_equal(got.succ, want.succ)
    assert got.cum.tobytes() == want.cum.tobytes()
    assert got.entropy_floor() == want.entropy_floor()
    for step in (0, 1, 9):
        g, w = got.shard_batch(step), want.shard_batch(step)
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype == np.int32
            np.testing.assert_array_equal(g[k], w[k])
        for n_shards in (2, batch):
            parts = [got.shard_batch(step, i, n_shards) for i in range(n_shards)]
            for i, part in enumerate(parts):
                ref = want.shard_batch(step, i, n_shards)
                np.testing.assert_array_equal(part["tokens"], ref["tokens"])
                np.testing.assert_array_equal(part["labels"], ref["labels"])
            np.testing.assert_array_equal(np.concatenate([p["tokens"] for p in parts]),
                                          g["tokens"])


def test_data_pipeline_deterministic():
    d1 = SyntheticLM(vocab=128, seq_len=16, global_batch=4, seed=3)
    d2 = SyntheticLM(vocab=128, seq_len=16, global_batch=4, seed=3)
    np.testing.assert_array_equal(d1.shard_batch(5)["tokens"], d2.shard_batch(5)["tokens"])
    assert not np.array_equal(d1.shard_batch(5)["tokens"], d1.shard_batch(6)["tokens"])
