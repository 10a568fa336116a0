from lako_tpu_torch.data.collator import ReaderBatch, ReaderCollator
from lako_tpu_torch.data.dataset import ReaderDataset, format_passages
from lako_tpu_torch.data.loader import batch_iterator

__all__ = ["ReaderBatch", "ReaderCollator", "ReaderDataset", "batch_iterator",
           "format_passages"]
