"""ray_tpu_torch.util — the SLO latency digests and the in-process span
API, the port's own copies of ray_tpu/util/slo.py and
ray_tpu/util/tracing.py."""
