from .layers import ParamSpec, init_params, load_jax_params, tree_paths
from .transformer import Model, build_model

__all__ = ["Model", "ParamSpec", "build_model", "init_params",
           "load_jax_params", "tree_paths"]
