"""The parallel layer: the (data, fsdp, tensor) mesh, the sharding rules and TP.

The JAX package's ``parallel/`` in the port (see ``mesh.py``, ``sharding.py``
and ``tensor_parallel.py``); ``dryrun.py`` trains one tiny step under each
factorization of the ranks it is launched on.
"""

from video_vae_tpu_torch.parallel.mesh import build_mesh, mesh_from_config  # noqa: F401
from video_vae_tpu_torch.parallel.sharding import (  # noqa: F401
    batch_sharding,
    constrain,
    param_shardings,
    replicated,
    shard_process_local_batch,
    shard_state,
)
