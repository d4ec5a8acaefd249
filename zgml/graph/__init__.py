from zgml.graph.tensor import LazyTensor, var, const  # noqa: F401
from zgml.graph.graph import ComputeGraph  # noqa: F401
from zgml.graph.op import Op  # noqa: F401
