from zgml.parallel.mesh import make_mesh  # noqa: F401
from zgml.parallel.tp import (  # noqa: F401
    llama_param_specs, shard_llama_params, make_sharded_forward,
    make_sharded_train_step,
)
