"""Parameterized, deterministic fabric generator (counterpart of
``repro.netsim.topogen``, a numpy-only copy: the same tables, regions,
diameters and error messages for the same spec string).

The built-in arithmetic fat-trees in ``netsim/topology.py`` hard-code two
shapes (2-tier, 3-tier).  This module generates *validated* ``TopologySpec``
tables for a wider family — 3-tier Clos, rail-optimized 2-tier, and
low-diameter direct ToR meshes (the Spritz target) — that the engine
consumes through ONE uniform table-driven router
(``topology.TableTopology``, one ``next_queue_table`` kernel launch per
tick) with no per-fabric special-casing.

A spec is a set of numpy tables over (switch, host) pairs:

  * a queue-id **region layout** partitioning ``[0, n_queues)`` exactly
    once, with the ``n_hosts`` host downlinks always last (queue
    ``t0_down_base + h`` delivers to host ``h`` — the engine's final-hop
    contract);
  * **up-port tables**: per (switch, dst) the contiguous block of
    candidate up/cross queues the EV hash (or adaptive least-queue choice)
    selects from, plus the per-switch degree;
  * **down-port tables**: per (switch, dst) the single deterministic
    down-queue toward ``dst``, or -1 when the switch must keep going up;
  * **ECMP salt planes**: the per-switch hash salts.  Clos fabrics salt
    per switch (independent EV→port mappings at every hop); the
    rail-optimized fabric shares one salt across all ToRs so a given
    (flow, EV) lands on the same rail everywhere — the property that makes
    rails congestion-disjoint for spraying senders.

Generators are pure functions of their integer parameters, addressed by a
spec string (``"clos3:pods=2,tors=2,hosts=4,aggs=2,up=2"``) so a fabric
can live on the frozen ``SimConfig`` (``cfg.fabric``) without making the
config unhashable.  ``build_spec`` is cached; equal strings always yield
identical tables.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

#: kinds build_spec() understands, with their required integer parameters.
GENERATORS: dict[str, tuple[str, ...]] = {
    "clos3": ("pods", "tors", "hosts", "aggs", "up"),
    "rail": ("tors", "hosts", "rails"),
    "mesh": ("tors", "hosts", "planes"),
}


@dataclasses.dataclass(frozen=True)
class Region:
    """One contiguous queue-id region: ``[base, base + size)``."""

    name: str
    base: int
    size: int


@dataclasses.dataclass(frozen=True, eq=False)
class TopologySpec:
    """Validated routing tables for one generated fabric.

    Switch ids are dense ``[0, n_switches)`` with the ``n_tors`` host-facing
    switches (ToRs) first; host ``h`` attaches to switch ``host_sw[h]``.
    Queue ``q`` (a directed link) feeds into switch ``q_sw[q]``; the
    ``n_hosts`` host downlinks are the final region (``q_sw == -1``) and
    queue ``t0_down_base + h`` delivers to host ``h``.

    Routing is uniform up/down: a packet at switch ``sw`` bound for ``dst``
    goes down via ``down_next[sw, dst]`` when that is >= 0, else sprays
    over the ``up_deg[sw]`` queues ``up_base[sw, dst] + [0, up_deg[sw])``
    selected by ``ecmp_hash(flow, ev, salt[sw], up_deg[sw])`` (or the
    adaptive least-queue choice).  Clos fabrics have dst-independent
    ``up_base`` columns; the mesh's cross links are dst-directed.
    """

    name: str
    params: dict
    n_hosts: int
    n_tors: int
    n_switches: int
    n_queues: int
    t0_down_base: int
    regions: tuple[Region, ...]
    diameter: int  # max switch hops on any src->dst path
    host_sw: np.ndarray  # (NH,) int32
    q_sw: np.ndarray  # (NQ,) int32, -1 on host downlinks
    up_base: np.ndarray  # (n_switches, NH) int32
    up_deg: np.ndarray  # (n_switches,) int32, 0 = top switch
    down_next: np.ndarray  # (n_switches, NH) int32, -1 = keep going up
    salt: np.ndarray  # (n_switches,) int32 ECMP salt planes
    sw_up_span: np.ndarray  # (n_switches, 2) int32 [base, size] of up block

    @property
    def max_up_deg(self) -> int:
        return int(self.up_deg.max()) if len(self.up_deg) else 1

    # ------------------------------------------------------------------
    def validate(self) -> None:
        """Structural invariants; each violation raises ``ValueError``.

        * the regions partition ``[0, n_queues)`` exactly once, with the
          host-downlink region exactly ``[t0_down_base, n_queues)``;
        * every queue feeds a real switch (or is a host downlink);
        * up blocks lie inside their switch's declared up span and match
          the declared degree;
        * every (switch, dst) either routes down to a valid queue or has a
          positive up degree — no routing dead ends.
        """
        NQ, NH, NS = self.n_queues, self.n_hosts, self.n_switches
        covered = np.zeros(NQ, np.int64)
        for r in self.regions:
            if r.size < 0 or r.base < 0 or r.base + r.size > NQ:
                raise ValueError(
                    f"{self.name}: region {r.name} [{r.base}, "
                    f"{r.base + r.size}) outside [0, {NQ})"
                )
            covered[r.base : r.base + r.size] += 1
        if (covered != 1).any():
            bad = int(np.nonzero(covered != 1)[0][0])
            raise ValueError(
                f"{self.name}: queue id {bad} covered {int(covered[bad])} "
                "times — regions must partition the queue-id space exactly "
                "once"
            )
        tail = next(r for r in self.regions if r.base == self.t0_down_base)
        if tail.size != NH or tail.base + tail.size != NQ:
            raise ValueError(
                f"{self.name}: host downlinks must be the final region "
                f"[{self.t0_down_base}, {NQ}) with one queue per host"
            )
        if self.host_sw.shape != (NH,) or (
            (self.host_sw < 0) | (self.host_sw >= self.n_tors)
        ).any():
            raise ValueError(f"{self.name}: host_sw must map hosts to ToRs")
        qs = self.q_sw
        if qs.shape != (NQ,):
            raise ValueError(f"{self.name}: q_sw must have shape ({NQ},)")
        if (qs[self.t0_down_base :] != -1).any():
            raise ValueError(
                f"{self.name}: host downlinks must have q_sw == -1"
            )
        mid = qs[: self.t0_down_base]
        if len(mid) and ((mid < 0) | (mid >= NS)).any():
            raise ValueError(
                f"{self.name}: q_sw of transit queues must be a switch id"
            )
        dn, ub, deg = self.down_next, self.up_base, self.up_deg
        if dn.shape != (NS, NH) or ub.shape != (NS, NH):
            raise ValueError(
                f"{self.name}: down_next/up_base must be (n_switches, "
                "n_hosts) tables"
            )
        if ((dn < -1) | (dn >= NQ)).any():
            raise ValueError(f"{self.name}: down_next entries outside [-1, {NQ})")
        needs_up = dn < 0  # (NS, NH)
        deg2 = np.broadcast_to(deg[:, None], (NS, NH))
        if (needs_up & (deg2 <= 0)).any():
            s = int(np.nonzero(needs_up.any(axis=1) & (deg <= 0))[0][0])
            raise ValueError(
                f"{self.name}: switch {s} has destinations it can neither "
                "route down nor spray up toward — routing dead end"
            )
        span_b = self.sw_up_span[:, 0][:, None]
        span_e = span_b + self.sw_up_span[:, 1][:, None]
        in_span = (ub >= span_b) & (ub + deg2 <= span_e)
        if (needs_up & ~in_span).any():
            s, d = [
                int(v[0]) for v in np.nonzero(needs_up & ~in_span)
            ][:2]
            raise ValueError(
                f"{self.name}: up block of switch {s} toward host {d} "
                "falls outside the switch's declared up span"
            )

    # ------------------------------------------------------------------
    def walk(self, src: int, dst: int, flow: int, ev: int) -> list[int]:
        """Numpy reference walk of one (src, dst, flow, EV) path — the
        queue ids visited, ending at ``dst``'s downlink.  Used by the
        property tests and as executable documentation of the router; the
        router in ``topology.TableTopology`` applies the same tables.
        """
        from repro_torch.netsim.topology import ecmp_hash_np

        path: list[int] = []
        sw = int(self.host_sw[src])
        for _ in range(self.diameter + 1):
            down = int(self.down_next[sw, dst])
            if down >= 0:
                path.append(down)
                if down >= self.t0_down_base:
                    return path
                sw = int(self.q_sw[down])
                continue
            deg = int(self.up_deg[sw])
            choice = ecmp_hash_np(flow, ev, int(self.salt[sw]), deg)
            q = int(self.up_base[sw, dst]) + choice
            path.append(q)
            sw = int(self.q_sw[q])
        raise ValueError(
            f"{self.name}: walk {src}->{dst} exceeded diameter "
            f"{self.diameter}: {path}"
        )


# ---------------------------------------------------------------------------
# generators
# ---------------------------------------------------------------------------
def _hosts_per_tor(n_hosts: int, n_tors: int) -> int:
    if n_tors <= 0 or n_hosts % n_tors:
        raise ValueError(
            f"hosts ({n_hosts}) must divide evenly over tors ({n_tors})"
        )
    return n_hosts // n_tors


def gen_clos3(pods: int, tors: int, hosts: int, aggs: int, up: int) -> TopologySpec:
    """3-tier Clos: ``pods`` pods of ``tors`` ToRs x ``hosts`` hosts each,
    ``aggs`` aggregation switches per pod, ``up`` core uplinks per agg
    (so ``aggs * up`` cores; core ``c`` attaches to agg ``c // up`` of
    every pod).  Queue layout and salts match the built-in arithmetic
    3-tier fat-tree, so for matching parameters the generated tables route
    bit-identically to ``Topology.build(tiers=3)``."""
    P, Tp, H, A, U = pods, tors, hosts, aggs, up
    if min(P, Tp, H, A, U) < 1:
        raise ValueError(f"clos3 parameters must be >= 1, got {(P, Tp, H, A, U)}")
    T = P * Tp  # total tors
    NH = T * H
    C = A * U  # cores
    NS = T + P * A + C  # tors, aggs, cores
    t0_up = 0
    agg_up = T * A
    core_down = agg_up + P * A * U
    agg_down = core_down + C * P
    t0_down = agg_down + P * A * Tp
    NQ = t0_down + NH

    regions = (
        Region("t0_up", t0_up, T * A),
        Region("agg_up", agg_up, P * A * U),
        Region("core_down", core_down, C * P),
        Region("agg_down", agg_down, P * A * Tp),
        Region("t0_down", t0_down, NH),
    )
    hostv = np.arange(NH, dtype=np.int64)
    host_sw = (hostv // H).astype(np.int32)
    dst_tor = hostv // H
    dst_pod = dst_tor // Tp
    dst_tor_local = dst_tor % Tp

    q_sw = np.full(NQ, -1, np.int32)
    q = np.arange(T * A, dtype=np.int64)  # t0_up[t, a]
    t, a = q // A, q % A
    q_sw[t0_up + q] = (T + (t // Tp) * A + a).astype(np.int32)
    q = np.arange(P * A * U, dtype=np.int64)  # agg_up[(p, a), u]
    pa, u = q // U, q % U
    q_sw[agg_up + q] = (T + P * A + (pa % A) * U + u).astype(np.int32)
    q = np.arange(C * P, dtype=np.int64)  # core_down[c, p]
    c, p = q // P, q % P
    q_sw[core_down + q] = (T + p * A + c // U).astype(np.int32)
    q = np.arange(P * A * Tp, dtype=np.int64)  # agg_down[(p, a), tl]
    pa, tl = q // Tp, q % Tp
    q_sw[agg_down + q] = ((pa // A) * Tp + tl).astype(np.int32)

    down_next = np.full((NS, NH), -1, np.int32)
    up_base = np.zeros((NS, NH), np.int32)
    up_deg = np.zeros(NS, np.int32)
    salt = np.zeros(NS, np.int32)
    sw_up_span = np.zeros((NS, 2), np.int32)
    # tors: down to local hosts, up over the pod's aggs (salt = tor id,
    # matching the arithmetic fat-tree's ecmp_hash(..., src_tor, A))
    for_t = np.arange(T, dtype=np.int64)
    up_deg[:T] = A
    salt[:T] = for_t.astype(np.int32)
    up_base[:T, :] = (t0_up + for_t * A)[:, None].astype(np.int32)
    sw_up_span[:T] = np.stack(
        [(t0_up + for_t * A).astype(np.int32), np.full(T, A, np.int32)], 1
    )
    local = dst_tor[None, :] == for_t[:, None]
    down_next[:T][local] = np.broadcast_to(
        (t0_down + hostv)[None, :], (T, NH)
    )[local].astype(np.int32)
    # aggs: down into their own pod, up over their cores (salt =
    # agg_global + 7919, matching the arithmetic fat-tree)
    pa = np.arange(P * A, dtype=np.int64)
    up_deg[T : T + P * A] = U
    salt[T : T + P * A] = (pa + 7919).astype(np.int32)
    up_base[T : T + P * A, :] = (agg_up + pa * U)[:, None].astype(np.int32)
    sw_up_span[T : T + P * A] = np.stack(
        [(agg_up + pa * U).astype(np.int32), np.full(P * A, U, np.int32)], 1
    )
    same_pod = dst_pod[None, :] == (pa // A)[:, None]
    agg_dn = agg_down + pa[:, None] * Tp + dst_tor_local[None, :]
    down_next[T : T + P * A][same_pod] = agg_dn[same_pod].astype(np.int32)
    # cores: pure down switches — every pod reachable
    cv = np.arange(C, dtype=np.int64)
    down_next[T + P * A :, :] = (
        core_down + cv[:, None] * P + dst_pod[None, :]
    ).astype(np.int32)

    return TopologySpec(
        name="clos3",
        params=dict(pods=P, tors=Tp, hosts=H, aggs=A, up=U),
        n_hosts=NH, n_tors=T, n_switches=NS, n_queues=NQ,
        t0_down_base=t0_down, regions=regions, diameter=5,
        host_sw=host_sw, q_sw=q_sw, up_base=up_base, up_deg=up_deg,
        down_next=down_next, salt=salt, sw_up_span=sw_up_span,
    )


RAIL_SALT = 0x5EED  # one shared salt plane: same (flow, EV) -> same rail


def gen_rail(tors: int, hosts: int, rails: int) -> TopologySpec:
    """Rail-optimized 2-tier fabric: ``rails`` spine planes, ToR ``t``'s
    uplink ``r`` attaches to rail ``r``.  All ToRs share ONE ECMP salt
    plane, so a (flow, EV) pair selects the same rail at every ToR — the
    rail-affinity property AI fabrics exploit (McClure et al.): a sprayed
    message's EVs stripe deterministically across rails with no cross-rail
    reconvergence."""
    T, H, R = tors, hosts, rails
    if min(T, H, R) < 1:
        raise ValueError(f"rail parameters must be >= 1, got {(T, H, R)}")
    NH = T * H
    NS = T + R
    t0_up = 0
    sp_down = T * R
    t0_down = sp_down + R * T
    NQ = t0_down + NH
    regions = (
        Region("t0_up", t0_up, T * R),
        Region("rail_down", sp_down, R * T),
        Region("t0_down", t0_down, NH),
    )
    hostv = np.arange(NH, dtype=np.int64)
    dst_tor = hostv // H
    host_sw = dst_tor.astype(np.int32)

    q_sw = np.full(NQ, -1, np.int32)
    q = np.arange(T * R, dtype=np.int64)  # t0_up[t, r] -> rail r
    q_sw[t0_up + q] = (T + q % R).astype(np.int32)
    q = np.arange(R * T, dtype=np.int64)  # rail_down[r, t] -> tor t
    q_sw[sp_down + q] = (q % T).astype(np.int32)

    down_next = np.full((NS, NH), -1, np.int32)
    up_base = np.zeros((NS, NH), np.int32)
    up_deg = np.zeros(NS, np.int32)
    salt = np.zeros(NS, np.int32)
    sw_up_span = np.zeros((NS, 2), np.int32)
    tv = np.arange(T, dtype=np.int64)
    up_deg[:T] = R
    salt[:T] = RAIL_SALT
    up_base[:T, :] = (t0_up + tv * R)[:, None].astype(np.int32)
    sw_up_span[:T] = np.stack(
        [(t0_up + tv * R).astype(np.int32), np.full(T, R, np.int32)], 1
    )
    local = dst_tor[None, :] == tv[:, None]
    down_next[:T][local] = np.broadcast_to(
        (t0_down + hostv)[None, :], (T, NH)
    )[local].astype(np.int32)
    rv = np.arange(R, dtype=np.int64)
    down_next[T:, :] = (sp_down + rv[:, None] * T + dst_tor[None, :]).astype(
        np.int32
    )
    return TopologySpec(
        name="rail",
        params=dict(tors=T, hosts=H, rails=R),
        n_hosts=NH, n_tors=T, n_switches=NS, n_queues=NQ,
        t0_down_base=t0_down, regions=regions, diameter=3,
        host_sw=host_sw, q_sw=q_sw, up_base=up_base, up_deg=up_deg,
        down_next=down_next, salt=salt, sw_up_span=sw_up_span,
    )


def gen_mesh(tors: int, hosts: int, planes: int) -> TopologySpec:
    """Low-diameter direct ToR mesh (the Spritz target): every ToR pair is
    joined by ``planes`` parallel links, giving a 2-switch-hop diameter.
    The EV sprays over the plane axis of the dst-directed link bundle —
    exactly the regime Spritz studies, where path diversity comes from
    parallel planes rather than multi-stage reconvergence.  Queue layout:
    ``mesh[t, j, l]`` (peer index ``j`` skips ``t`` itself) then host
    downlinks."""
    T, H, L = tors, hosts, planes
    if min(T, H, L) < 1:
        raise ValueError(f"mesh parameters must be >= 1, got {(T, H, L)}")
    NH = T * H
    NS = T
    n_mesh = T * (T - 1) * L
    t0_down = n_mesh
    NQ = t0_down + NH
    regions = tuple(
        r for r in (
            Region("mesh", 0, n_mesh),
            Region("t0_down", t0_down, NH),
        ) if r.size > 0 or r.name == "t0_down"
    )
    hostv = np.arange(NH, dtype=np.int64)
    dst_tor = hostv // H
    host_sw = dst_tor.astype(np.int32)

    q_sw = np.full(NQ, -1, np.int32)
    if n_mesh:
        q = np.arange(n_mesh, dtype=np.int64)
        t = q // ((T - 1) * L)
        j = (q // L) % (T - 1)
        peer = j + (j >= t)
        q_sw[q] = peer.astype(np.int32)

    down_next = np.full((NS, NH), -1, np.int32)
    up_base = np.zeros((NS, NH), np.int32)
    up_deg = np.zeros(NS, np.int32)
    salt = np.zeros(NS, np.int32)
    sw_up_span = np.zeros((NS, 2), np.int32)
    tv = np.arange(T, dtype=np.int64)
    up_deg[:] = L
    salt[:] = tv.astype(np.int32)
    if T > 1:
        sw_up_span[:] = np.stack(
            [(tv * (T - 1) * L).astype(np.int32),
             np.full(T, (T - 1) * L, np.int32)], 1
        )
        j = dst_tor[None, :] - (dst_tor[None, :] > tv[:, None])
        up_base[:] = (
            tv[:, None] * (T - 1) * L + np.clip(j, 0, T - 2) * L
        ).astype(np.int32)
    local = dst_tor[None, :] == tv[:, None]
    down_next[local] = np.broadcast_to(
        (t0_down + hostv)[None, :], (T, NH)
    )[local].astype(np.int32)
    return TopologySpec(
        name="mesh",
        params=dict(tors=T, hosts=H, planes=L),
        n_hosts=NH, n_tors=T, n_switches=NS, n_queues=NQ,
        t0_down_base=t0_down, regions=regions, diameter=2,
        host_sw=host_sw, q_sw=q_sw, up_base=up_base, up_deg=up_deg,
        down_next=down_next, salt=salt, sw_up_span=sw_up_span,
    )


# ---------------------------------------------------------------------------
# the spec-string front door (what SimConfig.fabric holds)
# ---------------------------------------------------------------------------
def parse_fabric(spec: str) -> tuple[str, dict]:
    """``"kind:k=v,k=v"`` -> (kind, params).  Raises ``ValueError`` on an
    unknown kind, a malformed pair, or missing/extra parameters, naming
    what a valid string looks like."""
    kind, _, rest = spec.partition(":")
    kind = kind.strip()
    if kind not in GENERATORS:
        raise ValueError(
            f"unknown fabric kind {kind!r}; known: {sorted(GENERATORS)}"
        )
    want = GENERATORS[kind]
    params: dict[str, int] = {}
    for pair in filter(None, (p.strip() for p in rest.split(","))):
        k, sep, v = pair.partition("=")
        if not sep or not v.strip().lstrip("-").isdigit():
            raise ValueError(
                f"malformed fabric parameter {pair!r} in {spec!r}; expected "
                f"'{kind}:' + comma-separated k=<int> pairs {want}"
            )
        params[k.strip()] = int(v)
    missing = [k for k in want if k not in params]
    extra = [k for k in params if k not in want]
    if missing or extra:
        raise ValueError(
            f"fabric {spec!r}: missing {missing or 'none'}, unexpected "
            f"{extra or 'none'}; {kind} takes exactly {want}"
        )
    return kind, params


_BUILDERS = {"clos3": gen_clos3, "rail": gen_rail, "mesh": gen_mesh}


@functools.lru_cache(maxsize=64)
def build_spec(spec: str) -> TopologySpec:
    """Parse + generate + validate the fabric named by ``spec``.  Cached:
    the generator is pure, so equal strings share one table set."""
    kind, params = parse_fabric(spec)
    out = _BUILDERS[kind](**params)
    out.validate()
    return out


def fabric_str(kind: str, **params: int) -> str:
    """The canonical spec string for (kind, params) — the inverse of
    ``parse_fabric``, handy for building ``SimConfig.fabric`` values."""
    want = GENERATORS[kind]  # KeyError on unknown kind is fine here
    return kind + ":" + ",".join(f"{k}={int(params[k])}" for k in want)
