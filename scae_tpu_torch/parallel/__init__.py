"""Meshes, steps and scans (counterpart of scae_tpu/parallel)."""

from scae_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    is_process_zero,
    make_mesh,
    maybe_initialize_distributed,
    param_shardings,
)
from scae_tpu_torch.parallel.train_step import (  # noqa: F401
    TrainState,
    loss_and_grads,
    make_eval_scan,
    make_fused_eval_step,
    make_fused_train_step,
    make_raw_eval_step,
    make_raw_train_step,
    make_train_scan,
    shard_state,
    unshard_state,
)
