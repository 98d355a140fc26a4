"""Distributions with explicit event axes (float32 likelihood math)."""
from vae_mdl_tpu_torch.distributions.base import Distribution, DistributionTuple
from vae_mdl_tpu_torch.distributions.continuous import Logistic, Normal
from vae_mdl_tpu_torch.distributions.discretized import (
    DiscretizedLogistic,
    discretized_logistic_log_prob,
)
from vae_mdl_tpu_torch.distributions.mixture import (
    MixtureDiscretizedLogistic,
    mixture_log_prob,
)

__all__ = [
    "DiscretizedLogistic",
    "Distribution",
    "DistributionTuple",
    "Logistic",
    "MixtureDiscretizedLogistic",
    "Normal",
    "discretized_logistic_log_prob",
    "mixture_log_prob",
]
