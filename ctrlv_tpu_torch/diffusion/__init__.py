from .scheduler import (
    EulerDiscreteScheduler,
    SchedulerState,
    edm_scalings,
    euler_step,
    karras_sigmas,
    scale_model_input,
)
