from lako_tpu_torch.models.t5.convert import init_fid_t5, params_from_jax
from lako_tpu_torch.models.t5.model import T5, FiDT5, T5Decoder, T5Encoder

__all__ = ["T5", "T5Encoder", "T5Decoder", "FiDT5", "init_fid_t5", "params_from_jax"]
