"""ActorPool (reference: `python/ray/util/actor_pool.py`): load-balance a
stream of tasks over a fixed set of actors.

The port's copy of ray_tpu/util/actor_pool.py."""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, List, Tuple

from .. import api


class ActorPool:
    def __init__(self, actors: Iterable[Any]):
        self._idle: List[Any] = list(actors)
        self._future_to_actor = {}
        self._pending: List[Tuple[Callable, Any]] = []

    def submit(self, fn: Callable[[Any, Any], Any], value: Any) -> None:
        """fn(actor, value) -> ObjectRef."""
        if self._idle:
            actor = self._idle.pop()
            ref = fn(actor, value)
            self._future_to_actor[ref] = actor
        else:
            self._pending.append((fn, value))

    def has_next(self) -> bool:
        return bool(self._future_to_actor) or bool(self._pending)

    def get_next_unordered(self, timeout: float = None) -> Any:
        if not self._future_to_actor:
            raise StopIteration("no pending results")
        done, _ = api.wait(
            list(self._future_to_actor), num_returns=1, timeout=timeout
        )
        if not done:
            raise TimeoutError("get_next_unordered timed out")
        ref = done[0]
        actor = self._future_to_actor.pop(ref)
        self._idle.append(actor)
        while self._pending and self._idle:
            fn, value = self._pending.pop(0)
            a = self._idle.pop()
            self._future_to_actor[fn(a, value)] = a
        return api.get(ref)

    def map_unordered(self, fn: Callable, values: Iterable[Any]) -> Iterator[Any]:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    def map(self, fn: Callable, values: Iterable[Any]) -> Iterator[Any]:
        refs = []
        values = list(values)
        idx = 0
        actors = list(self._idle)
        n = len(actors)
        for i, v in enumerate(values):
            refs.append(fn(actors[i % n], v))
        for ref in refs:
            yield api.get(ref)
