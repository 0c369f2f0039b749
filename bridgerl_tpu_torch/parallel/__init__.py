"""Data parallelism over processes (``mesh.py``), the counterpart of
``bridgerl_tpu/parallel/``."""

from .mesh import (
    Group,
    RankFailure,
    active,
    all_reduce_max,
    all_reduce_mean_,
    all_reduce_sum,
    all_reduce_sum_differentiable,
    barrier,
    broadcast,
    broadcast_module,
    gather_json,
    init_from_env,
    is_main,
    launch,
    pad_to_multiple,
    shard_rows,
    share,
    use_group,
    world_size,
)
