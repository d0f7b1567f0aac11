from mfm_tpu_torch.flows.cnf import (
    Transport,
    draw_probe,
    exact_divergence,
    flow_log_density,
    hutchinson_divergence,
    kernel_tangent_field,
    make_transport,
    module_tangent_field,
)
from mfm_tpu_torch.flows.flow_mh import FlowTarget, pullback_rwm, select_flow_kernel
from mfm_tpu_torch.flows.losses import (
    FMBatch,
    cond_fm_sample,
    flow_matching_loss,
    fm_sample,
)
from mfm_tpu_torch.flows.ode import odeint_grid
from mfm_tpu_torch.flows.train import (
    TrainState,
    adamw_finite,
    apply_gradients,
    create_train_state,
    decay_mask,
    make_lr_schedule,
)
from mfm_tpu_torch.flows.vector_field import (
    NON_LINEARITIES,
    VectorFieldNet,
    field_params,
)

__all__ = [
    "Transport",
    "draw_probe",
    "exact_divergence",
    "flow_log_density",
    "hutchinson_divergence",
    "kernel_tangent_field",
    "make_transport",
    "module_tangent_field",
    "FlowTarget",
    "pullback_rwm",
    "select_flow_kernel",
    "FMBatch",
    "cond_fm_sample",
    "flow_matching_loss",
    "fm_sample",
    "odeint_grid",
    "TrainState",
    "adamw_finite",
    "apply_gradients",
    "create_train_state",
    "decay_mask",
    "make_lr_schedule",
    "NON_LINEARITIES",
    "VectorFieldNet",
    "field_params",
]
