"""Distribution layer of the port: the partition rules
(:mod:`repro_torch.dist.sharding`, the JAX package's, copied) and the
placement of a tree on a mesh and its inverse
(:mod:`repro_torch.dist.elastic`), and the compressed int8 + error
feedback gradient all-reduce of data-parallel training
(:mod:`repro_torch.dist.collectives`).  The mesh itself and its
collectives live in :mod:`repro_torch.launch.mesh`."""
from . import collectives, elastic, sharding  # noqa: F401
from .elastic import (  # noqa: F401
    gather_tree,
    reshard_tree,
    train_state_specs,
    validate_batch_divisibility,
)
from .sharding import (  # noqa: F401
    cache_spec,
    cache_tree_specs,
    data_batch_spec,
    param_spec,
    tree_param_specs,
)
