"""Shared helpers of the port's serving tests: one serve run (prefill, then
decode steps) in either package, and the parity rule it is held to.

The rule (max|Δ| / max|ref|): logits within 1e-4 through the models' own
float32 steps and 3e-2 through the bfloat16 serve steps; each state leaf
by its dtype, float32 leaves within 1e-4 and bfloat16 leaves (the KV
caches, and the token-shift and conv leaves of bf16 activations) within
one bfloat16 step (2**-7) in the float32 steps, every leaf within 3e-2 in
the bfloat16 steps.

Through the bfloat16 steps two things are found, not absorbed by a wider
tolerance (``assert_bf16_close``): an MoE routing decision that bf16
rounding flips (the two experts' probabilities within one bf16 step on
one side; the rows it reaches are then not held past the flip's layer),
and, after the prefill, a (layer, row) block of a state leaf where the
reference's own bfloat16 run is already farther than 3e-2 from its float32
run (rounding amplified through the stack; the port is not held to 3e-2
where the reference does not meet it).  Everything else is held."""
import contextlib

import numpy as np
import torch

BF16_STEP = 2.0**-7

TOL = {"fp32": 1e-4, "bf16": 3e-2}
LEAF_TOL = {("fp32", "float32"): 1e-4, ("fp32", "bfloat16"): 2.0**-7,
            ("bf16", "float32"): 3e-2, ("bf16", "bfloat16"): 3e-2}


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def as_np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().cpu().numpy()
    return np.array(t, np.float32)  # a writable copy


def dtype_name(t) -> str:
    return str(t.dtype).removeprefix("torch.")


def fp32_steps(model):
    """The serve steps without the bfloat16 cast (the model's own prefill
    and decode), with decode returning cache_len + 1 as the serve step does."""
    def decode(params, state, tokens, clen):
        return (*model.decode_fn(params, state, tokens, clen), clen + 1)

    return model.prefill_fn, decode


def run_serve(prefill, decode, params, toks, wrap, P: int, max_len: int, states=None):
    """Prefill on the first P tokens of ``toks``, then one decode step per
    further token.  Returns the logits of every step (float32 numpy) and
    the state after every step (``{leaf: (float32 numpy, dtype name)}``).
    ``states`` (another run's states) makes each decode step start from
    that run's state, cast to this run's leaf dtypes, so that a step is held
    against the reference from the same inputs: a bfloat16 leaf element
    that rounds the other way moves the next step by more than the
    matmuls' own rounding."""
    logits, state, clen = prefill(params, {"tokens": wrap(toks[:, :P])}, max_len)
    snap = lambda st: {k: (as_np(v), dtype_name(v)) for k, v in st.items()}
    logits_out, states_out = [as_np(logits)], [snap(state)]
    for i, t in enumerate(range(P, toks.shape[1])):
        if states is not None:
            state = {k: wrap(v).to(state[k].dtype) for k, (v, _) in states[i].items()}
        logits, state, clen = decode(params, state, wrap(toks[:, t:t + 1]), clen)
        logits_out.append(as_np(logits))
        states_out.append(snap(state))
    assert int(clen) == toks.shape[1]
    return logits_out, states_out


def serve_errors(got, want, rows=None) -> dict:
    """The worst error of each step's logits and of every state leaf of
    ``got`` against ``want`` (two ``run_serve`` results), as ``{name:
    (error, dtype)}``; ``rows`` (a list per step) restricts a step to those
    batch rows.  Shapes and dtypes must match."""
    worst = {}

    def put(name, err, dtype):
        worst[name] = (max(worst.get(name, (0.0,))[0], err), dtype)

    for i, ((g, gs), (w, ws)) in enumerate(zip(zip(*got), zip(*want))):
        r = slice(None) if rows is None else rows[i]
        assert g.shape == w.shape and np.isfinite(g).all(), f"step {i}"
        if len(g[r]):
            put("logits", rel_err(g[r], w[r]), "logits")
        assert gs.keys() == ws.keys()
        for k in ws:
            (ga, gd), (wa, wd) = gs[k], ws[k]
            assert gd == wd and ga.shape == wa.shape, f"step {i}: {k} {gd} {wd}"
            if len(ga[:, r]):  # leaves are (L, B, ...)
                put(k, rel_err(ga[:, r], wa[:, r]), wd)
    return worst


def assert_serve_close(got, want, mode: str, rows=None) -> dict:
    """``serve_errors`` held to the rule above; returns the errors."""
    worst = serve_errors(got, want, rows)
    tol = {k: TOL[mode] if d == "logits" else LEAF_TOL[mode, d] for k, (_, d) in worst.items()}
    assert all(worst[k][0] <= tol[k] for k in worst), (worst, tol)
    return worst


# ---------------------------------------------------------------------------
# MoE routing: the port's recorder and the comparison of two runs' routing
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def port_routing(calls: list):
    """While active, every MoE call of the port appends its routing
    ``(probs (T, E), ids (T, k), keep (T*k,))`` as numpy to ``calls``."""
    from repro_torch.models import mlp

    orig = mlp.moe_routing

    def rec(xt, router, cfg):
        r = orig(xt, router, cfg)
        calls.append(tuple(r[k].detach().cpu().numpy() for k in ("probs", "ids", "keep")))
        return r

    mlp.moe_routing = rec
    try:
        yield calls
    finally:
        mlp.moe_routing = orig


def _near_tie(pa, pb) -> bool:
    return abs(pa - pb) <= BF16_STEP * max(pa, pb)


def routing_divergence(got: list, want: list, n_layers: int, batch: int) -> list:
    """Two runs' routing, call by call (``n_layers`` calls per serve step;
    a call's tokens are row-major over ``batch`` rows).  A token diverges at
    a call where its expert set or the kept mask of its assignments
    differs.  Returns, per step, ``{row: layer of the row's first
    divergence}``.  The first divergence of a row must be a near tie: the
    token's exchanged experts' probabilities within one bf16 step on one
    side; or, where only the kept mask differs, a call in which some
    token's expert set differs (it moved the capacity counts)."""
    assert len(got) == len(want) and len(got) % n_layers == 0
    out = []
    for s in range(len(got) // n_layers):
        first = {}
        for layer in range(n_layers):
            (gp, gi, gk), (wp, wi, wk) = got[s * n_layers + layer], want[s * n_layers + layer]
            T, k = gi.shape
            per_row = T // batch
            sets_differ = (np.sort(gi, -1) != np.sort(wi, -1)).any(-1)
            keep_g = {(t, e): bool(gk[t * k + j]) for t in range(T) for j, e in enumerate(gi[t])}
            keep_w = {(t, e): bool(wk[t * k + j]) for t in range(T) for j, e in enumerate(wi[t])}
            for t in range(T):
                if not sets_differ[t] and all(keep_g[t, e] == keep_w[t, e] for e in gi[t]):
                    continue
                row = t // per_row
                if row in first:
                    continue
                if sets_differ[t]:
                    a = [e for e in wi[t] if e not in gi[t]]
                    b = [e for e in gi[t] if e not in wi[t]]
                    assert any(_near_tie(p[ea], p[eb]) for p in (gp[t], wp[t]) for ea in a
                               for eb in b), (s, layer, t, gi[t], wi[t], gp[t], wp[t])
                else:
                    assert sets_differ.any(), (s, layer, t)
                first[row] = layer
        out.append(first)
    return out


def assert_bf16_close(got, want, want_fp32, diverged=None) -> dict:
    """The bfloat16 serve run ``got`` against the reference's ``want``,
    each step's logits per row and every state leaf per (layer, row) block
    (errors over the whole leaf's max|ref|), within 3e-2, except what the
    module docstring says is found instead: rows past their routing
    divergence (``diverged``, from ``routing_divergence``; logits of such a
    row, blocks of layers after the divergence) and, after the prefill,
    blocks where ``want`` is itself farther than 3e-2 from ``want_fp32``
    (the reference's float32 run).  Returns ``{leaf: worst held error}``
    and what was found (``"found"``: a list of (step, leaf, layer, row))."""
    tol = TOL["bf16"]
    worst, found = {}, []
    for i, ((g, gs), (w, ws)) in enumerate(zip(zip(*got), zip(*want))):
        div = diverged[i] if diverged else {}
        assert g.shape == w.shape and np.isfinite(g).all(), f"step {i}"
        norm = np.abs(w).max()
        for b in range(g.shape[0]):
            err = float(np.abs(g[b] - w[b]).max() / norm)
            if err <= tol:
                worst["logits"] = max(worst.get("logits", 0.0), err)
            elif b in div:
                found.append((i, "logits", None, b))
            else:
                raise AssertionError(f"step {i}: logits row {b}: {err}")
        assert gs.keys() == ws.keys()
        for name in ws:
            (ga, gd), (wa, wd) = gs[name], ws[name]
            assert gd == wd and ga.shape == wa.shape, f"step {i}: {name} {gd} {wd}"
            norm = np.abs(wa).max()
            blocks = np.abs(ga - wa).reshape(*wa.shape[:2], -1).max(-1) / norm
            own = None
            if i == 0:
                fa = want_fp32[1][0][name][0]
                own = np.abs(wa - fa).reshape(*wa.shape[:2], -1).max(-1) / norm
            for layer, b in np.ndindex(blocks.shape):
                err = float(blocks[layer, b])
                if err <= tol:
                    worst[name] = max(worst.get(name, 0.0), err)
                elif (b in div and layer > div[b]) or (own is not None and own[layer, b] > tol):
                    found.append((i, name, layer, b))
                else:
                    raise AssertionError(f"step {i}: {name} layer {layer} row {b}: {err}")
    return {"held": worst, "found": found}
