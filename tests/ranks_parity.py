"""What the port's rank tests run inside their ranks
(``repro_torch.distrib.ranks.run_ranks`` starts them with the ``spawn``
context, so the functions live in a module of their own that imports no
JAX): the reference's small scale-mode grid (``tests/test_scale_mode.py``:
16 hosts, 4 per ToR, 4 uplinks, RTO 120, the two-failure schedule) as a
row-sharded or conn-sharded ``SweepEngine``, each rank returning its
results as numpy arrays."""
import threading

import numpy as np
import torch

NH = 16


def run_ranks_beside(work, n: int, make_refs):
    """``work`` on ``n`` gloo ranks on the CPU (``run_ranks``), started in a
    thread while ``make_refs()`` runs in this one (the JAX references);
    returns ``(the ranks' results, the references)``, raising what either
    raised."""
    from repro_torch.distrib.ranks import run_ranks

    box = {}

    def start():
        try:
            box["ranks"] = run_ranks(work, n, "cpu", "gloo", timeout=600)
        except BaseException as e:  # raised below, in the caller's thread
            box["error"] = e

    thread = threading.Thread(target=start)
    thread.start()
    try:
        refs = make_refs()
    finally:
        thread.join()
    if "error" in box:
        raise box["error"]
    return box["ranks"], refs


def without_lb(state: dict) -> dict:
    """A state's leaves but the load balancer's (a sweep row's is a
    SwitchLB's; the reference's test excludes them)."""
    return {k: v for k, v in state.items() if not k.startswith("lb_state")}


def cfg(conn_sharding: bool):
    from repro_torch.netsim.config import SimConfig

    return SimConfig(n_hosts=NH, hosts_per_tor=4, uplinks_per_tor=4, rto_ticks=120,
                     conn_sharding=conn_sharding)


def schedule(failures):
    """The reference test's two failure windows (a down and a degraded
    uplink of ToR 0), in either package's ``failures`` module."""
    return failures.FailureSchedule(
        queue=np.array([16, 17], np.int32), start=np.array([50, 80], np.int32),
        end=np.array([150, 200], np.int32), kind=np.array([0, 1], np.int32),
        param=np.array([0, 0], np.int32))


def cases(net, workloads, failures):
    """``tests/test_scale_mode.py:41-63``: a/reps (two seeds, the failures)
    merges with b/ecmp, whose row freezes at its shorter horizon; the
    switch-adaptive c goes to a second bucket."""
    return [
        net.SweepCase("a/reps", workloads.permutation(NH, msg_pkts=24, seed=3), "reps",
                      ticks=400, failures=schedule(failures), seeds=(0, 1)),
        net.SweepCase("b/ecmp", workloads.permutation(NH, msg_pkts=16, seed=5), "ecmp",
                      ticks=300, seeds=(7,)),
        net.SweepCase("c/adaptive", workloads.permutation(NH, msg_pkts=12, seed=9),
                      "adaptive_roce", ticks=250, seeds=(1,)),
    ]


def port_cases():
    from repro_torch import netsim
    from repro_torch.netsim import failures, workloads

    return cases(netsim, workloads, failures)


def results(eng, res, collect: str) -> dict:
    """Every row's state (``interop.sim_state_to_numpy``) and, per collect
    mode, its trace or telemetry carry, with each bucket's ``ticks_run``."""
    from repro_torch.netsim import interop

    rows = {}
    for c in eng.cases:
        for si in range(len(c.seeds)):
            out = {"state": interop.sim_state_to_numpy(res.state_for(c.name, si))}
            if collect == "full":
                tr = res.trace_for(c.name, si)
                out["trace"] = {f: getattr(tr, f).numpy() for f in tr._fields}
            if collect == "summary":
                b, cell = res._find(c.name)
                out["telemetry"] = b.telemetry[cell.rows[si]].copy()
            rows[(c.name, si)] = out
    return {"rows": rows, "ticks_run": [b.ticks_run for b in res.buckets],
            "plan": eng.plan.describe()}


def meshes(world: int) -> dict:
    """What the sweep half of ``distrib.sharding`` makes over the group's
    ranks (every rank calls each, as making a mesh's groups is collective)."""
    from repro_torch.distrib import sharding as shd

    out = {"all": tuple(shd.sweep_mesh().shape), "one": shd.sweep_mesh(1),
           "names": shd.sweep_mesh().mesh_dim_names,
           "conn": tuple(shd.sweep_conn_mesh(2).shape),
           "conn_names": shd.sweep_conn_mesh(2).mesh_dim_names,
           "pad": [shd.pad_rows(n, shd.sweep_mesh()) for n in (1, 2, 3, 5)],
           "platform": shd.mesh_platform(shd.sweep_mesh())}
    try:
        shd.sweep_conn_mesh(world + 1)
    except ValueError as e:
        out["too_many"] = str(e)
    return out


def sweep_mesh_work(rank: int) -> dict:
    """The grid over a ``("rows",)`` mesh of every rank: ``collect="full"``
    to the horizons, then ``collect="summary"`` with the early exit."""
    import torch.distributed as dist

    from repro_torch.netsim import SweepEngine

    torch.set_num_threads(1)
    out_meshes = meshes(dist.get_world_size())
    eng = SweepEngine(cfg(False), port_cases(), device="cpu")  # devices="auto": the group
    full = results(eng, eng.run(collect="full"), "full")
    summary = results(eng, eng.run(collect="summary", early_exit=True), "summary")
    try:
        from repro_torch.netsim import SoakRunner

        SoakRunner(eng)
        soak = None
    except ValueError as e:
        soak = str(e)
    return {"full": full, "summary": summary, "n_devices": eng.n_devices, "meshes": out_meshes,
            "soak": soak,
            "row_rank": eng.row_rank,
            "padded": [b.plan.n_padded_rows for b in eng.buckets],
            "local_rows": [int(b.keys.shape[0]) for b in eng.buckets]}


def conn_axis_work(rank: int) -> dict:
    """The grid over a (rows 2, conns 2) mesh: ``collect="full"``, the
    guard rails, and each rank's bitmap rows."""
    from repro_torch.netsim import SweepEngine

    torch.set_num_threads(1)
    c = cfg(True)
    eng = SweepEngine(c, port_cases(), conn_devices=2, device="cpu")
    out = {"full": results(eng, eng.run(collect="full"), "full"),
           "mesh": tuple(eng.mesh.shape), "coord": tuple(eng.mesh.get_coordinate())}
    errors = {}
    try:
        SweepEngine(c.replace(conn_sharding=False), port_cases(), conn_devices=2, device="cpu")
    except ValueError as e:
        errors["opt_in"] = str(e)
    try:
        eng.run(collect="summary")
    except ValueError as e:
        errors["summary"] = str(e)
    out["errors"] = errors
    shapes = []
    for b in eng.buckets:
        carry = eng.bucket_carry(b)
        carry, _ = eng.run_chunk(b, carry, 0, 8)
        nc = b.sim.wl.n_conns
        shapes.append((nc, b.plan.n_padded_rows, tuple(carry.c_rtx.shape),
                       tuple(carry.c_rcv.shape), tuple(carry.c_inflight.shape)))
    out["bitmaps"] = shapes
    axis = eng.mesh.get_group("conns")
    out["step_scenario"] = [step_scenario_pair(c, axis),
                            step_scenario_pair(c.replace(rto_ticks=12, trimming=True), axis)]
    return out


def step_scenario_pair(c, axis, ticks: int = 200) -> tuple:
    """One REPS run (a/reps's scenario) stepped by ``step_scenario`` whole,
    and as this rank's block of ``axis`` then gathered: both as numpy.
    With an RTO shorter than a round trip and trimming, packets are sent
    again and delivered twice, so every bitmap read decides something."""
    from repro_torch.core import make_lb
    from repro_torch.netsim import Simulator, interop
    from repro_torch.netsim.engine import add_rows, drop_rows, gather_conn_state, shard_conn_state

    case = port_cases()[0]
    sim = Simulator(c, case.workload, make_lb("reps"), failures=case.failures, device="cpu")
    whole = sim.init_state()
    part = drop_rows(shard_conn_state(add_rows(whole), axis))
    for t in range(ticks):
        whole, _ = sim.step_scenario(whole, t, sim.base_key)
        part, _ = sim.step_scenario(part, t, sim.base_key, conn_axis=axis)
    back = drop_rows(gather_conn_state(add_rows(part), axis))
    return interop.sim_state_to_numpy(whole), interop.sim_state_to_numpy(back)


# ---------------------------------------------------------------------------
# checkpoint.restore(axes=): the elastic re-shard
# ---------------------------------------------------------------------------
RESHARD_ARCH = "mistral-nemo-12b"


def reshard_trees():
    """A reduced model's float32 parameters and an optimizer state of
    random moments (every value distinct from zero), with their logical
    axes; ``extra`` holds a leaf the axes leave out."""
    from repro_torch import rng
    from repro_torch.configs import all_configs, reduced
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import opt_state_axes
    from repro_torch.tree import tree_map_with_path

    model = build_model(reduced(all_configs()[RESHARD_ARCH]))
    params = model.init_params(rng.PRNGKey(0, device="cpu"), torch.float32)
    gen = np.random.RandomState(1)
    rand = lambda t: tree_map_with_path(
        lambda _, p: torch.from_numpy(gen.standard_normal(tuple(p.shape)).astype(np.float32)), t)
    opt = {"m": rand(params), "v": rand(params), "step": torch.tensor(7, dtype=torch.int32)}
    extra = {"w": torch.arange(24, dtype=torch.int32).reshape(4, 6),
             "flag": torch.tensor([True, False, True, True])}
    axes = {"params": model.param_axes(), "opt": opt_state_axes(model.param_axes()),
            "extra": {"w": ("batch", None)}}
    return {"params": params, "opt": opt, "extra": extra}, axes


def reshard_work(rank: int, path: str) -> dict:
    """Restore the checkpoint at ``path`` with ``axes=`` onto a (4, 1) and
    a (2, 2) ("data", "model") mesh under the baseline and fsdp rules;
    report, per leaf, its placements, whether this rank's local shard is
    bit-equal to its block of the saved array and whether ``full_tensor()``
    is bit-equal to the whole; and what a restore with no mesh gives."""
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import restore
    from repro_torch.distrib import sharding as shd
    from repro_torch.launch.dryrun import RULE_SETS
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.tree import tree_flatten_with_path

    torch.set_num_threads(1)
    like, axes = reshard_trees()
    saved = {name: dict(np.load(f"{path}/{name}.npz")) for name in like}
    out = {}
    for model_axis in (1, 2):
        mesh = make_host_mesh(model=model_axis, device="cpu")
        for rules in ("baseline", "fsdp"):
            with shd.mesh_rules(mesh, RULE_SETS[rules]):
                trees, step = restore(path, like, axes=axes)
            rows = {}
            for name, tree in trees.items():
                for k, t in tree_flatten_with_path(tree).items():
                    want = saved[name][k]
                    if not isinstance(t, DTensor):
                        rows[f"{name}/{k}"] = ("plain", np.array_equal(t.numpy(), want)
                                               and t.numpy().dtype == want.dtype)
                        continue
                    local = t.to_local().numpy()
                    block = [slice(0, n) for n in want.shape]
                    coord = mesh.get_coordinate()
                    for m, p in enumerate(t.placements):
                        if p.is_shard():
                            n = block[p.dim].stop - block[p.dim].start
                            size = n // mesh.size(m)
                            lo = block[p.dim].start + coord[m] * size
                            block[p.dim] = slice(lo, lo + size)
                    full = t.full_tensor().numpy()
                    rows[f"{name}/{k}"] = (
                        tuple(f"S{p.dim}" if p.is_shard() else "R" for p in t.placements),
                        local.dtype == want.dtype and np.array_equal(local, want[tuple(block)])
                        and full.dtype == want.dtype and np.array_equal(full, want))
            out[(tuple(mesh.shape), rules)] = (rows, step)
    plain, step = restore(path, like, axes=axes)  # no mesh active: as without axes
    out["no mesh"] = ({f"{n}/{k}": type(t).__name__ == "Tensor"
                       and np.array_equal(t.numpy(), saved[n][k])
                       for n, tree in plain.items()
                       for k, t in tree_flatten_with_path(tree).items()}, step)
    return out


# ---------------------------------------------------------------------------
# MoE expert parallelism
# ---------------------------------------------------------------------------
MOE_ARCH = "phi3.5-moe-42b-a6.6b"
MOE_BATCH, MOE_SEQ = 2, 16


def moe_cfg(no_drops: bool):
    """The reduced phi3.5-moe; ``no_drops``: a capacity no expert can reach
    (every token's assignments fit)."""
    import dataclasses

    from repro_torch.configs import all_configs, reduced

    cfg = reduced(all_configs()[MOE_ARCH])
    return dataclasses.replace(cfg, moe_capacity=float(cfg.n_experts)) if no_drops else cfg


def _counting_drops(mlp, drops: list):
    """Wrap ``mlp.moe_routing`` to add each call's dropped assignments to
    ``drops``."""
    orig = mlp.moe_routing

    def routing(*a, **k):
        r = orig(*a, **k)
        drops.append(int((~r["keep"]).sum()))
        return r

    mlp.moe_routing = routing


def moe_ep_work(rank: int) -> dict:
    """On a (1, 2) mesh (ranks 0-1 and 2-3 each form one) and a (2, 2)
    mesh, under the baseline and fsdp rules, in float64: the loss, its
    cross-entropy and aux parts, every gradient, and the parameters and
    moments after one train step against the no-mesh step (1e-9 of each
    leaf's largest; ``test_torch_mesh_parity``'s rule), with the drops
    counted; then, at the preset's binding capacity on the (2, 2) mesh, one
    MoE layer against ``_moe_local`` on each data shard on one device."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import rng
    from repro_torch.configs import ShapeConfig
    from repro_torch.distrib import sharding as shd
    from repro_torch.launch.dryrun import RULE_SETS, axes_to_shardings
    from repro_torch.models import build_model, mlp
    from repro_torch.train import TrainConfig, make_train_step
    from repro_torch.train.optimizer import init_opt_state, opt_state_axes
    from repro_torch.train.steps import make_grad_fn
    from repro_torch.tree import tree_flatten_with_path, tree_map_with_path
    from test_torch_mesh_parity import _close, _copy, _float64_everywhere

    torch.set_num_threads(1)
    _float64_everywhere()
    drops: list = []
    _counting_drops(mlp, drops)
    meshes = {(2, 2): init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model")),
              (1, 2): init_device_mesh("cpu", (2, 1, 2), mesh_dim_names=(
                  "replica", "data", "model"))["data", "model"]}
    cfg = moe_cfg(no_drops=True)
    model = build_model(cfg)
    shape = ShapeConfig("t", MOE_SEQ, MOE_BATCH, "train")
    rs = np.random.RandomState(0)
    batch = {k: torch.from_numpy(rs.randint(0, cfg.vocab, tuple(v.shape)).astype(np.int32))
             for k, v in model.input_specs(shape).items()}
    params = model.init_params(rng.PRNGKey(0, device="cpu"), torch.float64)
    opt = init_opt_state(params)
    tcfg = TrainConfig(compute_dtype=torch.float64)
    loss, metrics, grads = make_grad_fn(model, tcfg)(params, batch)
    p1, o1, m1 = make_train_step(model, tcfg)(_copy(params), _copy(opt), batch)
    checked = []
    for dims, mesh in meshes.items():
        for rules_name in ("baseline", "fsdp"):
            rules = RULE_SETS[rules_name]

            def place(tree, axes):
                pl = axes_to_shardings(mesh, axes, tree, rules)
                return tree_map_with_path(
                    lambda path, t: distribute_tensor(t, mesh, pl[path or "_"]), tree)

            what = f"{dims} {rules_name}"
            d_batch = place(batch, model.batch_axes(shape))
            with shd.mesh_rules(mesh, rules), implicit_replication():
                d_loss, d_metrics, d_grads = make_grad_fn(model, tcfg)(
                    place(params, model.param_axes()), d_batch)
                _close(d_loss, loss, f"{what} loss")
                for k in ("xent", "aux"):
                    _close(d_metrics[k], metrics[k], f"{what} {k}")
                for k, g in grads.items():
                    _close(d_grads[k], g, f"{what} grad {k}")
                d_opt = place(_copy(opt), opt_state_axes(model.param_axes()))
                p2, o2, m2 = make_train_step(model, tcfg)(
                    place(_copy(params), model.param_axes()), d_opt, d_batch)
            _close(m2["loss"], m1["loss"], f"{what} step loss")
            for part, got, want in (("param", p2, p1), ("opt", o2, o1)):
                got = tree_flatten_with_path(got)
                for k, t in tree_flatten_with_path(want).items():
                    _close(got[k], t, f"{what} {part} {k} after one step")
            checked.append(what)
    no_drop_total = sum(drops)

    # the binding capacity: per data shard, as the reference counts it
    cfg = moe_cfg(no_drops=False)
    mesh = meshes[(2, 2)]
    p = mlp.init_moe_params(rng.PRNGKey(3, device="cpu"), cfg, torch.float64)
    x = torch.from_numpy(np.random.RandomState(4).standard_normal(
        (4, 32, cfg.d_model)) + 0.5)
    del drops[:]
    want = torch.cat([mlp._moe_local(x[b:b + 2], p, cfg)[0] for b in (0, 2)])
    binding = sum(drops)
    rep = [Replicate(), Replicate()]
    d_p = {k: distribute_tensor(v, mesh, rep if k == "router" else [Replicate(), Shard(0)])
           for k, v in p.items()}
    with shd.mesh_rules(mesh, {}):
        y, aux = mlp.moe(distribute_tensor(x, mesh, [Shard(0), Replicate()]), d_p, cfg)
    _close(y, want, "binding capacity, y against each data shard's _moe_local")
    return {"checked": checked, "drops": no_drop_total, "binding_drops": binding,
            "y_placements": tuple("S0" if q.is_shard(0) else "R" for q in y.placements)}
