"""Several devices: the 1-D data mesh (``mesh``), and exact IK sharded over
it or streamed over large pose sets (``fleet``)."""

from ikflow_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    initialize_multihost,
    make_mesh,
    pad_to_multiple,
    replicate,
    shard_batch,
)

__all__ = ["DATA_AXIS", "Mesh", "initialize_multihost", "make_mesh", "pad_to_multiple", "replicate", "shard_batch"]
