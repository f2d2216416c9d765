from .layers import (
    ParamSpec, abstract_params, init_params, load_jax_params,
    param_shardings, tree_paths,
)
from .transformer import Model, build_model

__all__ = ["Model", "ParamSpec", "abstract_params", "build_model",
           "init_params", "load_jax_params", "param_shardings", "tree_paths"]
