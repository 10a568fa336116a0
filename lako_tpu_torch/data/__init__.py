from lako_tpu_torch.data.collator import ReaderBatch, ReaderCollator
from lako_tpu_torch.data.dataset import ReaderDataset, format_passages

__all__ = ["ReaderBatch", "ReaderCollator", "ReaderDataset", "format_passages"]
