"""Question vocabulary and pretrained word-vector embedding matrix: the port
of lako_tpu/text/dictionary.py, pinned to the original by
tests/test_torch_dataprep.py.

``Dictionary`` maps words to indices with the original LaKo question
tokenization and pickles ``(word2idx, idx2word)`` as the original does.
``WordVectors`` parses a local GloVe-format text file and caches an ``.npz``
beside it; unknown words get normal-init vectors. The cache stores the words
as a fixed-width unicode array and is read with ``allow_pickle=False``,
where the JAX package stores an object array and unpickles it: the two
packages' caches are different files and neither reads the other's.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np


class Dictionary:
    def __init__(self, word2idx: Optional[dict] = None,
                 idx2word: Optional[list] = None):
        self.word2idx = word2idx or {}
        self.idx2word = idx2word or []

    @property
    def ntoken(self) -> int:
        return len(self.word2idx)

    @property
    def padding_idx(self) -> int:
        return len(self.word2idx)

    def tokenize(self, sentence: str, add_word: bool = False) -> List[int]:
        """Lowercase, strip ',' and '?', split on whitespace after padding
        's, as the original LaKo code does."""
        sentence = sentence.lower()
        sentence = (sentence.replace(",", "").replace("?", "")
                    .replace("'s", " 's"))
        words = sentence.split()
        if add_word:
            return [self.add_word(w) for w in words]
        return [self.word2idx.get(w, self.padding_idx - 1 if self.idx2word else 0)
                for w in words]

    def add_word(self, word: str) -> int:
        if word not in self.word2idx:
            self.idx2word.append(word)
            self.word2idx[word] = len(self.idx2word) - 1
        return self.word2idx[word]

    def __len__(self) -> int:
        return len(self.idx2word)

    def dump_to_file(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump((self.word2idx, self.idx2word), f)

    @classmethod
    def load_from_file(cls, path: str) -> "Dictionary":
        with open(path, "rb") as f:
            word2idx, idx2word = pickle.load(f)
        return cls(word2idx, idx2word)


class WordVectors:
    """GloVe-format word vectors from a local text file, with .npz caching."""

    def __init__(self, txt_path: str, dim: Optional[int] = None,
                 cache: bool = True):
        txt = Path(txt_path)
        npz = txt.with_suffix(".npz")
        if cache and npz.exists():
            with np.load(npz, allow_pickle=False) as data:
                self.itos = data["itos"].tolist()
                self.vectors = data["vectors"]
        else:
            itos, vecs = [], []
            for line in txt.read_text(encoding="utf-8").splitlines():
                parts = line.rstrip().split(" ")
                if len(parts) < 2:
                    continue
                itos.append(parts[0])
                vecs.append(np.asarray(parts[1:], dtype=np.float32))
            self.itos = itos
            self.vectors = np.stack(vecs) if vecs else np.zeros((0, dim or 0))
            if cache:
                np.savez_compressed(npz, itos=np.asarray(itos, dtype=str),
                                    vectors=self.vectors)
        self.stoi = {w: i for i, w in enumerate(self.itos)}
        self.dim = self.vectors.shape[1] if len(self.vectors) else (dim or 300)

    def __contains__(self, token: str) -> bool:
        return token in self.stoi

    def __getitem__(self, token: str) -> np.ndarray:
        i = self.stoi.get(token, -1)
        if i >= 0:
            return self.vectors[i]
        return np.random.default_rng(abs(hash(token)) % (2**32)) \
            .normal(size=self.dim).astype(np.float32)

    def embedding_matrix(self, dictionary: Dictionary,
                         pad_extra: int = 1) -> np.ndarray:
        """(ntoken + pad_extra, dim) init matrix for a question encoder;
        words without a vector keep zeros."""
        out = np.zeros((len(dictionary) + pad_extra, self.dim), dtype=np.float32)
        for word, idx in dictionary.word2idx.items():
            if word in self.stoi:
                out[idx] = self.vectors[self.stoi[word]]
        return out


def build_id2question(questions: Sequence[dict]) -> Dict[str, str]:
    """question_id → question text."""
    return {str(q["question_id"]): q["question"] for q in questions}
