from lako_tpu_torch.signal.aggregate import (
    aggregate_fact_scores,
    aggregate_fact_scores_device,
    apply_ans_attention_bonus,
    attach_scores_to_examples,
)

__all__ = [
    "aggregate_fact_scores",
    "aggregate_fact_scores_device",
    "apply_ans_attention_bonus",
    "attach_scores_to_examples",
]
