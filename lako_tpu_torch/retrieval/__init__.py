from lako_tpu_torch.retrieval.eval import hit_at_k
from lako_tpu_torch.retrieval.index import DenseIndex, add_facts_to_examples
from lako_tpu_torch.retrieval.pq import PQIndex

__all__ = ["DenseIndex", "PQIndex", "add_facts_to_examples", "hit_at_k"]
