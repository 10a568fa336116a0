from lako_tpu_torch.models.bert.convert import (
    init_retriever,
    jax_param_paths,
    params_from_jax,
    state_dict_from_hf_bert,
)
from lako_tpu_torch.models.bert.model import BertEncoder

__all__ = ["BertEncoder", "init_retriever", "jax_param_paths", "params_from_jax",
           "state_dict_from_hf_bert"]
