from .common import ModelConfig, ParamDef, init_params
from .model import SHAPE_CELLS, Model, ShapeCell, input_specs
from .weights import params_from_numpy, train_state_from_numpy

__all__ = ["ModelConfig", "ParamDef", "Model", "SHAPE_CELLS", "ShapeCell", "init_params",
           "input_specs", "params_from_numpy", "train_state_from_numpy"]
