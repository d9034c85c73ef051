"""The port's models: the dense decoder LM of the JAX package's model zoo.

Plain functions over nested dicts of tensors (``layers``, ``transformer``),
the ``Model`` API, and ``convert.params_from_reference`` to load JAX weights.
"""

from .api import Model
from .config import BlockDesc, ModelConfig
from .convert import params_from_reference
from .module import (ParamSpec, init_params, param_count, spec_leaves,
                     spec_tree_map)

__all__ = [
    "Model", "BlockDesc", "ModelConfig", "params_from_reference",
    "ParamSpec", "init_params", "param_count", "spec_leaves", "spec_tree_map",
]
