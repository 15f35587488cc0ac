from gslora_tpu_torch.baselines.regularization import (  # noqa: F401
    estimate_importance,
    make_reg_step,
    run_regularization_task,
)
from gslora_tpu_torch.baselines.distill import (  # noqa: F401
    make_distill_step,
    run_distill_task,
)
