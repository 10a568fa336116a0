from lako_tpu_torch.models.t5.convert import (
    init_fid_t5,
    jax_param_paths,
    params_from_jax,
    state_dict_from_hf_t5,
    t5_config_from_hf,
)
from lako_tpu_torch.models.t5.model import T5, FiDT5, T5Decoder, T5Encoder

__all__ = ["T5", "T5Encoder", "T5Decoder", "FiDT5", "init_fid_t5", "jax_param_paths",
           "params_from_jax", "state_dict_from_hf_t5", "t5_config_from_hf"]
