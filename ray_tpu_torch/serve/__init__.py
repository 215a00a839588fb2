"""ray_tpu_torch.serve — the continuous-batching engine and its LLM server."""

from .config import SpeculationConfig  # noqa: F401
from .engine import EngineConfig, InferenceEngine, Request  # noqa: F401
from .llm import LLMServer  # noqa: F401
