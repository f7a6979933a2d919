from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer,
    OptState,
    global_norm,
    make_optimizer,
    opt_init_specs,
)
