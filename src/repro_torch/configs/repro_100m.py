"""repro-100m: the ~100M-parameter GELU-dense LM, the paper-representative
workload (GeGLU MLPs with gelu_tanh, swapped to PWL by the plan)."""
import dataclasses

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="repro-100m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=32000,
    activation="gelu_tanh",
    mlp_type="geglu",
    norm_type="rmsnorm",
)


def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=512, remat=False,
    )
