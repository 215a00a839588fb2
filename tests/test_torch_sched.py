"""The port's scheduler (ray_tpu_torch.sched: the torus model, the sub-slice
packer, placement groups) against ray_tpu's, on the CPU.

The same request sequences go to both packers, and the same placement
groups to both runtimes on the same virtual cluster (nodes added in the
same order, the same `add_slice` shapes): the allocations (origin, shape,
coordinates, hosts) and each group's bundles and bundle -> node map (nodes
named by the order they joined) must be equal. The accelerator resource
is the one deliberate difference: the reference's "TPU" is the port's
"GPU", normalised before the comparison.
"""

import time

import pytest

import ray_tpu
import ray_tpu.cluster_utils
import ray_tpu_torch
import ray_tpu_torch.cluster_utils
from ray_tpu.sched import topology as jtopo
from ray_tpu_torch.sched import topology as ttopo

THREAD_MODE = {"worker_processes": 0, "actor_processes": False}
WAIT_S = 20

# (generation, shape, steps): a step is a shape to allocate, or ("free", i)
# to release the i-th allocation made so far
PACKER_CASES = [
    ("v5p", (4, 4, 4), [(2, 2, 2)] * 8 + [(1, 1, 1), ("free", 0), (2, 2, 2)]),
    ("v5p", (2, 2, 8), [(8, 1, 1), (2, 2, 2), (4,), (1, 2, 1), ("free", 1), (2, 2, 4)]),
    ("v5p", (2, 2, 4), [(2, 2, 1)] * 4 + [("free", 1), ("free", 3), (2, 2, 2), ("free", 2),
                                          (2, 2, 2)]),
    ("v5e", (8, 8), [(2, 2), (4, 4), (8, 1), (2, 4), ("free", 1), (4, 4), (3, 3)]),
    ("v4", (4, 4, 8), [(4, 4, 4), (2, 2, 2), (1, 4, 8), ("free", 0), (4, 4, 4)]),
    ("v6e", (4, 4), [(1, 1)] * 3 + [(4, 4), ("free", 0), (2, 2)]),
]


def _pack(topo_mod, generation, shape, steps):
    topo = topo_mod.SliceTopology(generation, shape)
    packer = topo_mod.SubSlicePacker(topo)
    ids, out = [], []
    for step in steps:
        if step[0] == "free":
            packer.release(ids[step[1]])
            out.append(("free", packer.free_chips()))
            continue
        got = packer.try_allocate(step)
        if got is None:
            out.append(None)
            continue
        aid, alloc = got
        ids.append(aid)
        out.append((alloc.origin, alloc.shape, sorted(alloc.coords()),
                    packer.hosts_for(alloc), packer.free_chips(),
                    round(packer.fragmentation(), 9)))
    return (topo.num_chips, topo.num_hosts, topo.host_partition(), out,
            packer.could_ever_fit((shape[0] * 2,) + tuple(shape[1:])))


@pytest.mark.parametrize("generation,shape,steps", PACKER_CASES,
                         ids=[f"{g}-{'x'.join(map(str, s))}" for g, s, _ in PACKER_CASES])
def test_packer_allocations_match_reference(generation, shape, steps):
    assert _pack(ttopo, generation, shape, steps) == _pack(jtopo, generation, shape, steps)


def test_topology_tables_match_reference():
    assert {k: vars(v) for k, v in ttopo.GENERATIONS.items()} == {
        k: vars(v) for k, v in jtopo.GENERATIONS.items()}
    for name in ("v5p-16", "v4-32", "v5e-8"):
        a, b = ttopo.SliceTopology.from_name(name), jtopo.SliceTopology.from_name(name)
        assert (a.generation, a.shape, a.num_hosts) == (b.generation, b.shape, b.num_hosts)
    for chips in (1, 4, 8, 12, 64):
        for dims in (2, 3):
            assert ttopo._default_shape(chips, dims) == jtopo._default_shape(chips, dims)


# ----------------------------------------------------------- placement groups


class Side:
    def __init__(self, name):
        self.name = name
        self.api = {"ray_tpu": ray_tpu, "ray_tpu_torch": ray_tpu_torch}[name]
        self.cu = {"ray_tpu": ray_tpu.cluster_utils,
                   "ray_tpu_torch": ray_tpu_torch.cluster_utils}[name]
        self.accel = "TPU" if name == "ray_tpu" else "GPU"
        self.sched = __import__(f"{name}.sched", fromlist=["placement_group"])
        self.strategy = __import__(f"{name}.core.task_spec",
                                   fromlist=["x"]).PlacementGroupSchedulingStrategy
        self.topology_request = __import__(f"{name}.core.task_spec",
                                           fromlist=["x"]).TopologyRequest

    def norm(self, bundle):
        return {("ACCEL" if k == self.accel else k): v for k, v in sorted(bundle.items())}

    def accel_bundle(self, n):
        return {self.accel: float(n)}


def _group(side, cluster, pg):
    index = {nid: i for i, nid in enumerate(cluster.runtime.agents)}
    if not pg.ready(timeout=0.2):
        return ("queued", [side.norm(b) for b in pg.bundles])
    allocs = [(a.origin, a.shape, a.bundle_indices, a.coords_per_bundle)
              for a in pg.topology_allocations]
    return ([side.norm(b) for b in pg.bundles], [index[n] for n in pg.bundle_nodes], allocs)


def _error(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — compared across the packages
        return type(e).__name__
    return None


def pg_strategies(side, cluster):
    for r in ({"CPU": 4.0}, {"CPU": 4.0, "ssd": 1.0}, {"CPU": 16.0}):
        cluster.add_node(resources=r)
    pgs, out = [], []
    for bundles, strategy in (([{"CPU": 2.0}, {"CPU": 2.0}], "PACK"),
                              ([{"CPU": 1.0}] * 3, "SPREAD"),
                              ([{"CPU": 6.0}, {"CPU": 6.0}], "STRICT_PACK"),
                              ([{"CPU": 1.0}] * 4, "STRICT_SPREAD"),
                              ([{"ssd": 1.0}], "PACK")):
        pgs.append(side.sched.placement_group(bundles, strategy=strategy))
        out.append(_group(side, cluster, pgs[-1]))
    out.append(_error(lambda: side.sched.placement_group([{"CPU": 1.0}] * 5,
                                                          strategy="STRICT_SPREAD")))
    out.append(_error(lambda: side.sched.placement_group([{"CPU": 10_000.0}])))
    out.append(_error(lambda: side.sched.placement_group([{"CPU": 1.0}], strategy="NOPE")))
    avail = [side.norm(a.resources.available()) for a in cluster.runtime.agents.values()]
    for pg in pgs:
        side.sched.remove_placement_group(pg)
    restored = [side.norm(a.resources.available()) for a in cluster.runtime.agents.values()]
    return out, avail, restored


def pg_topology_bundles(side, cluster):
    tr = side.topology_request
    cluster.add_slice(num_hosts=2, chips_per_host=4)  # v5e, 2 hosts of a 2x2
    cluster.add_slice(generation="v5p", topology_shape=(2, 2, 4))
    out = [_group(side, cluster, side.sched.placement_group([tr((2, 2, 1))]))]
    span = side.sched.placement_group([tr((2, 2, 2))])
    out.append(_group(side, cluster, span))
    layers = [side.sched.placement_group([tr((2, 2, 1))]) for _ in range(2)]
    out += [_group(side, cluster, pg) for pg in layers]
    out.append(_error(lambda: side.sched.placement_group([tr((4, 4, 4))])))
    queued = side.sched.placement_group([tr((2, 2, 2))])  # feasible, busy: queues
    out.append(_group(side, cluster, queued))
    side.sched.remove_placement_group(span)
    out.append(_group(side, cluster, queued))  # lands where the span was
    return out


def pg_actor_in_accel_bundle(side, cluster):
    cluster.add_node(resources={"CPU": 4.0, side.accel: 1.0})
    pg = side.sched.placement_group([side.accel_bundle(1)])
    kw = {f"num_{side.accel.lower()}s": 1}

    @side.api.remote(num_cpus=0, scheduling_strategy=side.strategy(
        placement_group_id=pg.id, bundle_index=0), **kw)
    class OnCard:
        def where(self):
            return "bundle"

    a = OnCard.remote()
    got = side.api.get(a.where.remote(), timeout=WAIT_S)
    # the bundle is held while the actor lives: a second one stays pending

    @side.api.remote(num_cpus=0, scheduling_strategy=side.strategy(
        placement_group_id=pg.id, bundle_index=0), **kw)
    def second():
        return "ran"

    ref = second.remote()
    ready, _ = side.api.wait([ref], num_returns=1, timeout=0.3)
    side.api.kill(a)
    after = side.api.get(ref, timeout=WAIT_S)
    return got, _group(side, cluster, pg), len(ready), after


def run_cluster(name, flow):
    side = Side(name)
    side.api.shutdown()
    config = __import__(f"{name}.core.config", fromlist=["config"]).config
    config.apply_overrides(dict(THREAD_MODE))
    cluster = None
    try:
        cluster = side.cu.Cluster(initialize_head=True)
        return flow(side, cluster)
    finally:
        if cluster is not None:
            cluster.shutdown()
        config.reset()


@pytest.mark.parametrize("flow", [pg_strategies, pg_topology_bundles, pg_actor_in_accel_bundle],
                         ids=lambda f: f.__name__)
def test_placement_groups_match_reference(flow):
    t0 = time.monotonic()
    ref = run_cluster("ray_tpu", flow)
    port = run_cluster("ray_tpu_torch", flow)
    assert port == ref
    assert time.monotonic() - t0 < 60
