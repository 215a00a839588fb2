"""Dedicated worker processes for actors: crash isolation with a mailbox RPC.

The port's copy of ray_tpu/core/actor_process.py holds, for now, only what
the node agent imports: `ActorProcessCrash`, the error an actor's dead
worker process surfaces as. The processes themselves (`ActorProcess`, the
child's serve loop, `_InstanceProxy`) wait for ROADMAP A5b; until then
every actor runs on the node agent's threads, and init() refuses
`actor_processes` on. Device actors stay in the process that owns the card
even then: a forked child cannot take CUDA work.
"""

from __future__ import annotations


class ActorProcessCrash(RuntimeError):
    """The actor's dedicated worker process died."""
