"""Data parallelism over ``torch.distributed`` (the counterpart of
``pose3d_tpu/parallel``)."""

from pose3d_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    broadcast_parameters,
    init_distributed,
    make_mesh,
    pad_to_multiple,
    pmean_,
    psum_,
    shard_batch,
)
