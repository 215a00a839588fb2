"""ray_tpu_torch.core — the runtime's core, the port's copies of ray_tpu/core:
ids, the flag registry (config), the control plane, the cluster scheduler,
the object store, ledger and transfer plane, the node agents and the
owner-side Runtime (core_worker), in thread mode, and the Prometheus
metrics, and the health plane (health.py: alert rules, the alert
lifecycle, the routers' ReplicaHealth). The process pool, the shm store
and actor processes wait for ROADMAP A5b; cross-host, RPC, federation and
persistence for A5c."""
