"""Device meshes and the sharded compute paths (port of
sober_tpu/parallel): one process drives a mesh of devices, as in the JAX
package; see parallel/mesh.py."""
from .mesh import make_mesh, replicate, shard_candidates
from .sharded import (
    sharded_acquisition,
    sharded_barycenter_sums,
    sharded_fbgp_batch_predict,
    sharded_nystrom_features,
    sharded_pi_weights,
    sharded_recombination,
)

__all__ = [
    "make_mesh",
    "shard_candidates",
    "replicate",
    "sharded_pi_weights",
    "sharded_nystrom_features",
    "sharded_barycenter_sums",
    "sharded_recombination",
    "sharded_acquisition",
    "sharded_fbgp_batch_predict",
]
