"""ray_tpu_torch.rl — RL at scale (reference: RLlib, new API stack shape):
EnvRunner sampling actors + learner updates on tensors; PPO for control,
GRPO and the online loop for LLM RLHF. The port's counterpart of
ray_tpu.rl, with its exports and `module_from_numpy`, which carries a
reference module tree across."""

from .appo import APPO, APPOConfig  # noqa: F401
from .dqn import DQN, DQNConfig  # noqa: F401
from .env import CartPole, Env, GymWrapper  # noqa: F401
from .env_runner import EnvRunner, EnvRunnerGroup, VectorEnvRunner  # noqa: F401
from .grpo import GRPO, GRPOConfig  # noqa: F401
from .online import OnlineRLConfig, OnlineRLLoop, Trajectory  # noqa: F401
from .impala import IMPALA, IMPALAConfig, vtrace_targets  # noqa: F401
from .module import (  # noqa: F401
    init_mlp_module,
    mlp_forward,
    mlp_forward_np,
    module_from_numpy,
)
from .multi_agent import (  # noqa: F401
    MultiAgentEnv,
    MultiAgentEnvRunner,
    MultiAgentPPO,
    MultiAgentPPOConfig,
    MultiCartPole,
)
from .offline import (  # noqa: F401
    BC,
    BCConfig,
    CQL,
    CQLConfig,
    MARWIL,
    MARWILConfig,
    load_offline_dataset,
    rollouts_to_dataset,
    save_rollouts,
)
from .ppo import PPO, PPOConfig, compute_gae  # noqa: F401
from .replay_buffer import PrioritizedReplayBuffer, ReplayBuffer, SumTree  # noqa: F401
from .sac import SAC, SACConfig  # noqa: F401
from .connectors import (  # noqa: F401
    ClipObs,
    ClipReward,
    Connector,
    ConnectorPipeline,
    FlattenObs,
    LambdaConnector,
    MaskLogits,
    NormalizeObs,
    ScaleObs,
    build_pipeline,
)
