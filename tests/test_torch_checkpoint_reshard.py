"""``checkpoint.restore(axes=)``, the elastic re-shard (reference
``checkpoint.py:216-235``): a checkpoint saved from one process (plain
tensors) is restored by four gloo ranks (started once for the file by
``repro_torch.distrib.ranks.run_ranks``; the work is in
``tests/ranks_parity.py``) onto a (4, 1) and a (2, 2) ``("data",
"model")`` mesh under the baseline and fsdp rules.  Every leaf with axes
comes back a ``DTensor`` placed as its axes give, its local shard bit-equal
to its block of the saved array and its ``full_tensor()`` to the whole;
leaves without axes, and every leaf with no mesh active, come back as
plain tensors equal to the saved ones."""
import pytest
import torch

from repro_torch.checkpoint import restore, save
from repro_torch.distrib.ranks import run_ranks
from repro_torch.tree import tree_flatten_with_path
from ranks_parity import reshard_trees, reshard_work

torch.set_num_threads(1)  # the suite's parallel workers share the host's cores

WORLD = 4


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("reshard") / "step_7")
    trees, axes = reshard_trees()
    save(path, 7, trees, axes=axes)
    return run_ranks(reshard_work, WORLD, "cpu", "gloo", args=(path,), timeout=600), trees


def test_every_leaf_is_bit_equal_on_every_rank(run):
    ranks, trees = run
    n_leaves = sum(len(tree_flatten_with_path(t)) for t in trees.values())
    for rank, out in enumerate(ranks):
        layouts = [k for k in out if k != "no mesh"]
        assert sorted(layouts) == sorted([((4, 1), "baseline"), ((4, 1), "fsdp"),
                                          ((2, 2), "baseline"), ((2, 2), "fsdp")])
        for layout in layouts:
            rows, step = out[layout]
            assert step == 7 and len(rows) == n_leaves
            bad = [k for k, (_, ok) in rows.items() if not ok]
            assert not bad, (rank, layout, bad)


def test_placements_follow_the_axes_and_rules(run):
    ranks, _ = run
    for out in ranks:
        base, fsdp = out[((2, 2), "baseline")][0], out[((2, 2), "fsdp")][0]
        # leaves the axes leave out come back plain
        assert base["extra/flag"][0] == "plain"
        # the embedding (vocab, embed): vocab over model; fsdp adds embed over data
        assert base["params/embed"][0] == ("R", "S0")
        assert fsdp["params/embed"][0] == ("S1", "S0")
        assert fsdp["opt/m/embed"][0] == fsdp["params/embed"][0]
        assert out[((4, 1), "baseline")][0]["extra/w"][0] == ("S0", "R")
        assert base["opt/step"][0] == ("R", "R")
        # some leaf is sharded over both axes somewhere, and some over data alone
        placed = [p for layout in out if layout != "no mesh" for p, _ in out[layout][0].values()]
        assert any("R" not in p for p in placed if p != "plain")


def test_no_mesh_restores_plain_tensors(run, tmp_path):
    ranks, trees = run
    for out in ranks:
        rows, step = out["no mesh"]
        assert step == 7 and all(rows.values()), [k for k, ok in rows.items() if not ok]
    # and in this process, with no group at all
    _, axes = reshard_trees()
    save(str(tmp_path / "c"), 3, trees, axes=axes)
    got, step = restore(str(tmp_path / "c"), trees, axes=axes)
    assert step == 3
    for name, tree in trees.items():
        flat = tree_flatten_with_path(got[name])
        for k, t in tree_flatten_with_path(tree).items():
            assert type(flat[k]) is torch.Tensor and torch.equal(flat[k], t), (name, k)
