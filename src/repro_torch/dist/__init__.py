"""Distribution layer of the port: the partition rules
(:mod:`repro_torch.dist.sharding`, the JAX package's, copied) and the
placement of a tree on a mesh (:mod:`repro_torch.dist.elastic`).  The
mesh itself and its collectives live in :mod:`repro_torch.launch.mesh`.
The compressed collectives of training come with the training mesh
slice."""
from . import elastic, sharding  # noqa: F401
from .elastic import reshard_tree, validate_batch_divisibility  # noqa: F401
from .sharding import (  # noqa: F401
    cache_spec,
    cache_tree_specs,
    data_batch_spec,
    param_spec,
    tree_param_specs,
)
