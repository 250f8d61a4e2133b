"""The plain reference against the JAX package, at the fig06 cell's own
fabric and traffic: ``reference/witness_fig06_ft128.json`` holds the digest
of every leaf of the reference's rows, taken when they were found equal bit
for bit to the JAX package's sweep over the same batch.  The reference is a
frozen copy of the port's plain formulation; this ties it to the package
the port was ported from at the benchmark's sizes (FATTREE_128, 4,096-packet
messages, a failure window open), not only at the CI fabrics."""
from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np
import torch

from portbench import check, generator, reference

HERE = Path(__file__).resolve().parent


def test_reference_matches_the_jax_witness():
    torch.set_num_threads(1)
    w = json.loads((HERE / "reference" / "witness_fig06_ft128.json").read_text())
    fabric = json.loads((HERE / "configs" / f"{w['config']}.json").read_text())["fabric"]
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    traffic["seeds_per_lb"] = w["seeds_per_lb"]
    batch = generator.make_batch(fabric, traffic, w["seed"], 0)
    rows = list(range(len(batch.rows)))
    ref = reference.Rows(fabric, batch, rows, "cpu")
    states, tel = ref.take_rows(ref.step(ref.carry0(), 0, w["ticks"]), rows)
    leaves = check.flatten(states)
    leaves["telemetry"] = tel.numpy()
    got = {k: hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest()
           for k, v in sorted(leaves.items())}
    assert got.keys() == w["digests"].keys()
    assert [k for k in got if got[k] != w["digests"][k]] == []
