from .mesh import (make_mesh, param_specs, shard_fused, shard_network,
                   sharded_forward, sharded_train_step, zero1_place,
                   zero1_shardings)
from .pipeline import PipelineMLP, make_pipeline_mesh, pipeline_forward, pipeline_train_step, shard_pipeline_model
from .ir_pipeline import (
    describe_partition,
    ir_pipeline_grads,
    ir_pipeline_train_step,
    partition_network,
    partition_network_circular,
    shard_pipelined_params,
    split_network,
    split_network_hetero,
    split_network_hetero_circular,
    split_network_hetero_tp,
    split_network_hetero_tp_circular,
    unchain,
)
from .distributed import init_distributed, shutdown_distributed
from .plan import describe_plans, plan_meshes
