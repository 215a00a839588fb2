"""ICI torus topology model and sub-slice packing.

The TPU-native replacement for the reference's scalar resource model
(upstream ray treats accelerators as counts — `num_gpus`, custom "TPU"
resources in `python/ray/_private/accelerators/tpu.py`): here a slice is a
3D torus of chips with known coordinates, a gang request is a *shape*
(e.g. 2x2x4), and the packer allocates axis-aligned sub-boxes so collectives
ride contiguous ICI links and the torus doesn't fragment.

Known generations follow public TPU topology tables (v4/v5p are 3D tori with
4 chips/host; v5e/v6e are 2D meshes with 1-8 chips/host).

The port's copy of ray_tpu/sched/topology.py, unchanged: the packer, the
generations and the virtual cluster's `add_slice` shapes stay the
reference's, and a slice's chips count as "GPU" where the port's resources
name them (task_spec, placement_group).
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

Coord = Tuple[int, ...]


@dataclass(frozen=True)
class TpuGeneration:
    name: str
    dims: int  # torus rank (2 or 3)
    chips_per_host: int
    hbm_gib_per_chip: float
    bf16_tflops_per_chip: float


GENERATIONS: Dict[str, TpuGeneration] = {
    "v4": TpuGeneration("v4", 3, 4, 32.0, 275.0),
    "v5e": TpuGeneration("v5e", 2, 4, 16.0, 197.0),
    "v5p": TpuGeneration("v5p", 3, 4, 95.0, 459.0),
    "v6e": TpuGeneration("v6e", 2, 4, 32.0, 918.0),
}


def _prod(shape: Sequence[int]) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


@dataclass(frozen=True)
class SliceTopology:
    """A physical slice: generation + chip-grid shape (+ torus wraparound)."""

    generation: str
    shape: Tuple[int, ...]
    wraparound: bool = False  # full-size slices get wraparound links

    @property
    def num_chips(self) -> int:
        return _prod(self.shape)

    @property
    def num_hosts(self) -> int:
        gen = GENERATIONS[self.generation]
        return max(1, self.num_chips // gen.chips_per_host)

    @classmethod
    def from_name(cls, name: str) -> "SliceTopology":
        """Parse accelerator names like 'v5p-16' (16 = chip count *2 for v5p
        TensorCores — we use plain chip counts: v5p-16 → 8 chips, 2x2x2)."""
        gen_name, _, count_str = name.partition("-")
        if gen_name not in GENERATIONS:
            raise ValueError(f"unknown TPU generation in {name!r}")
        gen = GENERATIONS[gen_name]
        count = int(count_str)
        chips = count // 2 if gen_name in ("v4", "v5p") else count
        shape = _default_shape(chips, gen.dims)
        return cls(gen_name, shape, wraparound=chips >= 64)

    def all_coords(self) -> List[Coord]:
        return list(itertools.product(*[range(d) for d in self.shape]))

    def host_of(self, coord: Coord) -> int:
        """Host index owning a chip coordinate: hosts own contiguous 2x2
        blocks in the x-y plane (4-chip hosts -> 2x2x1 sub-blocks on v4/v5p;
        v5e/v6e hosts likewise connect a 2x2 chip square)."""
        gen = GENERATIONS[self.generation]
        bx, by = coord[0] // 2, coord[1] // 2
        hosts_x = max(1, -(-self.shape[0] // 2))
        if gen.dims == 3:
            hosts_y = max(1, -(-self.shape[1] // 2))
            return (coord[2] * hosts_y + by) * hosts_x + bx
        return by * hosts_x + bx

    def host_partition(self) -> Dict[int, List[Coord]]:
        """host index -> chip coords. Callers registering a slice should
        check the partition is uniform (every host owns chips_per_host
        chips) before enabling topology-aware placement on it — odd-dim
        shapes produce ragged partitions that no real slice has."""
        out: Dict[int, List[Coord]] = {}
        for c in self.all_coords():
            out.setdefault(self.host_of(c), []).append(c)
        return out


def _default_shape(chips: int, dims: int) -> Tuple[int, ...]:
    """Near-cubic factorization, powers of two preferred (matches how real
    slices are provisioned: 2x2x1, 2x2x2, 2x2x4, 4x4x4, ...)."""
    if dims == 2:
        best = (1, chips)
        for a in range(1, int(chips**0.5) + 1):
            if chips % a == 0:
                best = (a, chips // a)
        return best
    best: Tuple[int, ...] = (1, 1, chips)
    for a in range(1, int(round(chips ** (1 / 3))) + 2):
        if chips % a:
            continue
        rest = chips // a
        for b in range(a, int(rest**0.5) + 1):
            if rest % b == 0:
                c = rest // b
                if c >= b >= a:
                    best = (a, b, c)
    return tuple(sorted(best))


def _normalize_rank(want: Tuple[int, ...], dims: int) -> Optional[Tuple[int, ...]]:
    """Pad a short request with 1s; squeeze 1-sized axes from a long one
    (a (2,2,1) request is a (2,2) box on a 2D mesh). None if impossible."""
    while len(want) > dims and 1 in want:
        i = want.index(1)
        want = want[:i] + want[i + 1:]
    if len(want) > dims:
        return None
    if len(want) < dims:
        want = want + (1,) * (dims - len(want))
    return want


@dataclass
class Allocation:
    """An axis-aligned sub-box of a slice granted to a gang."""

    origin: Coord
    shape: Tuple[int, ...]

    def coords(self) -> List[Coord]:
        return [
            tuple(o + d for o, d in zip(self.origin, delta))
            for delta in itertools.product(*[range(s) for s in self.shape])
        ]

    @property
    def num_chips(self) -> int:
        return _prod(self.shape)


class SubSlicePacker:
    """Allocates axis-aligned sub-boxes from a torus, minimizing fragmentation.

    Strategy: for each requested shape (tried in every axis permutation),
    scan candidate origins in lexicographic order and pick the placement
    with the tightest fit against already-allocated boxes (corner-first
    packing). This is the ICI-aware heart of gang placement — the thing the
    reference's bundle packer (`gcs_placement_group_scheduler.cc`) never had
    to do because NCCL doesn't care about torus coordinates.
    """

    def __init__(self, topology: SliceTopology):
        self.topology = topology
        self._lock = threading.RLock()
        self._free: Set[Coord] = set(topology.all_coords())
        self._allocations: Dict[int, Allocation] = {}
        self._next_id = 0

    def try_allocate(self, shape: Sequence[int]) -> Optional[Tuple[int, Allocation]]:
        want = _normalize_rank(tuple(shape), len(self.topology.shape))
        if want is None:
            raise ValueError(
                f"request shape {tuple(shape)} does not fit topology rank "
                f"{len(self.topology.shape)}"
            )
        dims = len(self.topology.shape)
        with self._lock:
            best: Optional[Allocation] = None
            best_score: Optional[Tuple] = None
            for perm in sorted(set(itertools.permutations(want))):
                if any(p > s for p, s in zip(perm, self.topology.shape)):
                    continue
                # corner-first: take the lexicographically first fit per
                # permutation, then prefer the permutation touching the
                # fewest hosts (gang stays host-local when possible)
                for origin in itertools.product(
                    *[range(s - p + 1) for p, s in zip(perm, self.topology.shape)]
                ):
                    alloc = Allocation(origin, perm)
                    coords = alloc.coords()
                    if all(c in self._free for c in coords):
                        n_hosts = len({self.topology.host_of(c) for c in coords})
                        score = (n_hosts, sum(origin), origin)
                        if best_score is None or score < best_score:
                            best, best_score = alloc, score
                        break
            if best is None:
                return None
            for c in best.coords():
                self._free.discard(c)
            alloc_id = self._next_id
            self._next_id += 1
            self._allocations[alloc_id] = best
            return alloc_id, best

    def release(self, alloc_id: int) -> None:
        with self._lock:
            alloc = self._allocations.pop(alloc_id, None)
            if alloc is not None:
                self._free.update(alloc.coords())

    def free_chips(self) -> int:
        with self._lock:
            return len(self._free)

    def hosts_for(self, alloc: Allocation) -> List[int]:
        return sorted({self.topology.host_of(c) for c in alloc.coords()})

    def fragmentation(self) -> float:
        """1 - (largest allocatable cube / free chips). 0 = perfectly packed."""
        with self._lock:
            free = len(self._free)
        if free == 0:
            return 0.0
        # probe the largest power-of-two cube that still fits
        dims = len(self.topology.shape)
        size = 1
        while True:
            probe = tuple([size * 2] * dims)
            if _prod(probe) > free:
                break
            if self._fits(probe):
                size *= 2
            else:
                break
        return 1.0 - (size**dims) / free

    def _fits(self, shape: Tuple[int, ...]) -> bool:
        with self._lock:
            for origin in itertools.product(
                *[range(s - p + 1) for p, s in zip(shape, self.topology.shape)]
            ):
                alloc = Allocation(origin, shape)
                if all(c in self._free for c in alloc.coords()):
                    return True
        return False

    def could_ever_fit(self, shape: Sequence[int]) -> bool:
        """True if some axis permutation of `shape` fits an EMPTY torus —
        the feasibility test for queueing vs rejecting a gang request."""
        want = _normalize_rank(tuple(shape), len(self.topology.shape))
        if want is None:
            return False
        return any(
            all(p <= s for p, s in zip(perm, self.topology.shape))
            for perm in itertools.permutations(want)
        )


@dataclass
class SliceInfo:
    """A registered physical slice: topology + packer + host->node map.

    The control plane keeps one of these per TPU slice so gang placement
    (sched/placement_group.py) can allocate contiguous sub-boxes and pin
    bundles to the hosts that own the allocated chips.
    """

    slice_id: object  # SliceID (kept untyped here: core imports this module)
    topology: SliceTopology
    packer: SubSlicePacker = None  # type: ignore[assignment]
    hosts: Dict[int, object] = field(default_factory=dict)  # host idx -> NodeID

    def __post_init__(self):
        if self.packer is None:
            self.packer = SubSlicePacker(self.topology)
