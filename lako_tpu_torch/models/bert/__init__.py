from lako_tpu_torch.models.bert.convert import (
    bert_config_from_hf,
    init_retriever,
    jax_param_paths,
    params_from_jax,
    retriever_state_dict_from_hf_bert,
    state_dict_from_hf_bert,
)
from lako_tpu_torch.models.bert.model import BertEncoder

__all__ = ["BertEncoder", "bert_config_from_hf", "init_retriever", "jax_param_paths",
           "params_from_jax", "retriever_state_dict_from_hf_bert", "state_dict_from_hf_bert"]
