from zgml.nn.layers import (  # noqa: F401
    linear, linear_init, silu, gelu, dropout, causal_mask, batchnorm2d_init,
    batchnorm2d, kaiming_init, argmax,
)
from zgml.nn.losses import mean_sq_err, cross_entropy, cross_entropy_idx  # noqa: F401
from zgml.nn.train import train_supervised, train_unsupervised  # noqa: F401
