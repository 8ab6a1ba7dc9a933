"""ray_tpu_torch.rllib: ray_tpu.rllib on PyTorch.

Port of ray_tpu/rllib (reference surface: python/ray/rllib —
AlgorithmConfig/Algorithm (algorithms/algorithm.py:212), EnvRunnerGroup
(env/env_runner_group.py), RLModule (core/rl_module/rl_module.py),
Learner/LearnerGroup (core/learner/learner.py:112, learner_group.py:101),
PPO, IMPALA, APPO, DQN, SAC, the offline BC, MARWIL, CQL and IQL, and
multi-agent training over a MultiAgentEnv). Learners and the runners'
policy run on ``AlgorithmConfig.device`` ("cuda" by default); environments
are the port's own copies (``envs``); runtime services come from a runtime
object (``LocalRuntime`` by default, ``_runtime.py``).
"""

from ._runtime import LocalRuntime
from .algorithm import Algorithm, AlgorithmConfig
from .appo import APPO, APPOConfig, AppoLearner
from .connectors import (ClipRewards, Connector, ConnectorPipeline,
                         FlattenObs, FrameStack, NormalizeObs)
from .cql import CQL, CQLConfig
from .dqn import DQN, DQNConfig, DQNLearner
from .env_runner import EnvRunner, EnvRunnerGroup
from .impala import (IMPALA, AggregatorActor, IMPALAConfig, ImpalaLearner,
                     vtrace)
from .iql import IQL, IQLConfig
from .learner import Learner, LearnerGroup, compute_gae
from .multi_agent import (MultiAgentEnv, MultiAgentEnvRunner,
                          MultiAgentEnvRunnerGroup)
from .offline import (BC, MARWIL, BCConfig, BCLearner, MARWILConfig,
                      OfflineTransitionAlgorithm, episodes_to_batch,
                      episodes_to_transitions)
from .ppo import PPO, PPOConfig
from .replay_buffers import (EpisodeReplayBuffer, PrioritizedReplayBuffer,
                             ReplayBuffer)
from .rl_module import RLModule, RLModuleSpec
from .sac import SAC, SACConfig, SACLearner

__all__ = [
    "Algorithm", "AlgorithmConfig", "AggregatorActor", "APPO",
    "APPOConfig", "AppoLearner", "BC", "BCConfig", "BCLearner",
    "CQL", "CQLConfig", "ClipRewards", "Connector", "ConnectorPipeline",
    "DQN", "DQNConfig", "DQNLearner", "EnvRunner", "EnvRunnerGroup",
    "EpisodeReplayBuffer", "FlattenObs", "FrameStack", "IMPALA",
    "IMPALAConfig", "IQL", "IQLConfig", "ImpalaLearner", "Learner",
    "LearnerGroup", "LocalRuntime", "MARWIL", "MARWILConfig",
    "MultiAgentEnv", "MultiAgentEnvRunner", "MultiAgentEnvRunnerGroup",
    "NormalizeObs", "OfflineTransitionAlgorithm", "PrioritizedReplayBuffer",
    "ReplayBuffer", "SAC", "SACConfig", "SACLearner", "compute_gae",
    "episodes_to_batch", "episodes_to_transitions", "PPO",
    "PPOConfig", "RLModule", "RLModuleSpec", "vtrace",
]
