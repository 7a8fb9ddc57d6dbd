"""Multi-device paths of the port: process groups (``mesh``), the
data-parallel train step and training pair (``train_dp``, ``fused_dp``),
the spatially sharded rollout (``spatial``) and the spawned ranks' bodies
(``ranks``)."""

from vsnca_tpu_torch.parallel.mesh import make_mesh, replicate, shard_along
from vsnca_tpu_torch.parallel.spatial import spatial_rollout
from vsnca_tpu_torch.parallel.train_dp import make_dp_train_step

__all__ = ["make_mesh", "replicate", "shard_along", "spatial_rollout", "make_dp_train_step"]
