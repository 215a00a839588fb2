"""ray_tpu_torch.core — the runtime's core, the port's copies of ray_tpu/core:
ids, the flag registry (config), the control plane, the cluster scheduler,
the object store, ledger and transfer plane, the node agents and the
owner-side Runtime (core_worker), the worker-process pool and actor
processes over the C++ shared-memory store (process_pool, actor_process,
shm_store, memory_monitor), the Prometheus metrics, and the health plane
(health.py: alert rules, the alert lifecycle, the routers'
ReplicaHealth), control-plane snapshots (persistence) and the session log
monitor (log_monitor). Cross-host, RPC and federation wait for ROADMAP
A5c."""
