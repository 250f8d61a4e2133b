"""The sweep's flight recorder on the CPU, continued from
tests/test_torch_tracer_sweep.py: a horizon-merged bucket's short row
freezes its ring at its own horizon (equal to JAX's and to the serial
``run_serial`` of that horizon), and the chunk primitives with ``trace=``
(``bucket_carry`` / ``run_chunk`` / ``finalize_bucket``) give ``run``'s
rings under any chunking."""
import torch

import repro_torch.netsim.tracer as ttracer
from sweep_parity import J, T, case, engines
from test_torch_tracer_sweep import SPEC, decode_equal, fail_grid, spec

torch.set_num_threads(1)  # the suite's parallel workers share the host's cores


def test_frozen_horizon_row_ring_stops_at_its_own_horizon():
    def cases(m):
        wl = m.net.workloads.permutation(32, 48, seed=1)
        return [case(m, "short/ops", wl, "ops", 200), case(m, "long/reps", wl, "reps", 500)]

    je, te = engines(cases, packer={"waste_budget": 2.0})
    assert len(te.buckets) == 1 and te.buckets[0].program.masked
    jres = je.run(collect="summary", chunk=150, trace=spec(J))
    tres = te.run(collect="summary", chunk=150, trace=spec(T))
    for name, ticks in (("short/ops", 200), ("long/reps", 500)):
        decode_equal(tres.flight_for(name), jres.flight_for(name), name)
        sim = te.serial_sim(name)
        _, trc = ttracer.run_serial(sim, ticks, spec(T))
        decode_equal(tres.flight_for(name), spec(T).build(sim, ticks).decode_row(trc.numpy()), name)


def test_chunk_primitives_carry_the_ring():
    """``bucket_carry`` / ``run_chunk`` / ``finalize_bucket`` with
    ``trace=``: the carry is ``(states, tel, trc)``, any chunking gives
    ``run``'s rings."""
    _, te = engines(fail_grid, packer={"merge": False})
    whole = te.run(collect="summary", trace=spec(T))
    _, te2 = engines(fail_grid, packer={"merge": False})
    for b in te2.buckets:
        carry = te2.bucket_carry(b, "summary", None, spec(T))
        assert len(carry) == 3 and carry[2].shape == (b.plan.n_padded_rows, 3 + 3 * SPEC["ring"])
        t0 = 0
        for n in (70, 130, 1000):
            n = min(n, b.ticks - t0)
            if n <= 0:
                break
            carry, _ = te2.run_chunk(b, carry, t0, n, "summary", None, spec(T))
            t0 += n
        te2.finalize_bucket(b, carry, "summary", t0, None, None, spec(T))
    from repro_torch.netsim.sweep import SweepResult
    res = SweepResult(te2)
    for c in te.cases:
        decode_equal(res.flight_for(c.name), whole.flight_for(c.name), c.name)
