"""ray_tpu_torch.serve — online serving: the controller reconciles
declarative deployments into replica actors, a pow-2 router balances
requests, the HTTP proxy exposes JSON routes and the OpenAI front, and
LLMServer/InferenceEngine provide continuously-batched paged-KV LLM
inference on the card.

The port's counterpart of ray_tpu/serve/__init__.py, with disaggregated
prefill/decode serving (DisaggCoordinator, EngineWorker, deploy_disagg,
DisaggConfig), the fleet controller that scales, remediates and re-syncs
its replicas (FleetConfig, FleetController), the declarative config
(serve/schema.py) and the gRPC ingress (start_grpc; `grpc` is imported
only when it starts).
"""

from .api import (  # noqa: F401
    delete,
    get_app_handle,
    get_deployment_handle,
    grpc_port,
    http_port,
    run,
    shutdown,
    start_grpc,
    status,
)
from .batching import batch  # noqa: F401
from .multiplex import get_multiplexed_model_id, multiplexed  # noqa: F401
from .config import (  # noqa: F401
    AutoscalingConfig,
    DeploymentConfig,
    DisaggConfig,
    SpeculationConfig,
)
from .deployment import Application, Deployment, deployment  # noqa: F401
from .disagg import (  # noqa: F401
    DisaggCoordinator,
    EngineWorker,
    deploy_disagg,
)
from .engine import EngineConfig, InferenceEngine, Request  # noqa: F401
from .fleet import FleetConfig, FleetController  # noqa: F401
from .handle import DeploymentHandle, DeploymentResponse  # noqa: F401
from .llm import LLMServer  # noqa: F401
from .openai_api import (  # noqa: F401
    ByteTokenizer,
    OpenAIServer,
    build_openai_app,
)
from .proxy_actor import ProxyActor, start_proxy  # noqa: F401
