"""ray_tpu_torch.core — the flag registry and the Prometheus metrics, the
port's own copies of ray_tpu/core/config.py and ray_tpu/core/metrics.py."""
