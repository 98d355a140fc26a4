from vae_mdl_tpu_torch.parallel.mesh import (
    batch_sharding,
    make_mesh,
    n_slices,
    replicated,
    sample_sharding,
    shard_batch,
    shard_state,
)
from vae_mdl_tpu_torch.parallel.tensor import (
    make_tp_mesh,
    shard_batch_tp,
    shard_state_tp,
    tp_param_spec,
    tp_state_sharding,
)

__all__ = [
    "make_mesh",
    "n_slices",
    "batch_sharding",
    "replicated",
    "sample_sharding",
    "shard_batch",
    "shard_state",
    "make_tp_mesh",
    "shard_batch_tp",
    "shard_state_tp",
    "tp_param_spec",
    "tp_state_sharding",
]
