"""Several cards: the (data, frame) mesh of ranks, data-parallel training
with ZeRO-1, and frame-sharded sampling. Counterpart of
``ctrlv_tpu/parallel/``."""

from .frames import FrameShard, current_frame_shard, frame_sharded
from .mesh import (
    AXES,
    COLLECTIVES,
    Mesh,
    MeshAxes,
    all_gather,
    all_reduce,
    init_from_env,
    make_mesh,
    make_train_mesh,
    reset_collective_counts,
    train_mesh_shape,
)
from .sharding import (
    Zero1,
    data_parallel_sharding,
    gathered_opt_state,
    replicate,
    shard_train_state,
    shares,
    zero1_plan,
)
