"""Multi-device execution over ``torch.distributed`` (the JAX package's
``parallel/``): process meshes, point-sharded voting, scene-parallel
evaluation (``scene_parallel``) and spawned ranks (``launch``)."""

from canonicalvoting_tpu_torch.parallel.hv_sharded import hough_voting_sharded  # noqa: F401
from canonicalvoting_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, factor_mesh, init_from_env, make_mesh)
