from zgml.optim.sgd import sgd_init, sgd_update, sgd_momentum_update  # noqa: F401
from zgml.optim.adam import adam_init, adam_update, AdamConfig  # noqa: F401
