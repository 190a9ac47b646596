from .common import ModelConfig, ParamDef, init_params
from .model import Model
from .weights import params_from_numpy, train_state_from_numpy

__all__ = ["ModelConfig", "ParamDef", "Model", "init_params", "params_from_numpy",
           "train_state_from_numpy"]
