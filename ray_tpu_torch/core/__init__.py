"""ray_tpu_torch.core — the runtime's core, the port's copies of ray_tpu/core:
ids, the flag registry (config), the control plane, the cluster scheduler,
the object store, ledger and transfer plane, the node agents and the
owner-side Runtime (core_worker), in thread mode, and the Prometheus
metrics. The process pool, the shm store and actor processes wait for
ROADMAP A5b; cross-host, RPC, federation, persistence and the health plane
for A5c (health.py holds only the serve router's ReplicaHealth)."""
