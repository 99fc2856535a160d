"""Data and tensor parallelism over ``torch.distributed`` (the
counterpart of ``pose3d_tpu/parallel``): the (data, model) mesh and its
collectives (``mesh.py``), the model axis' parameter sharding
(``sharding.py``) and the multi-process dry run (``dryrun.py``)."""

from pose3d_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    broadcast_parameters,
    gather_model,
    init_distributed,
    make_mesh,
    pad_to_multiple,
    pmean_,
    psum_,
    shard_batch,
)
