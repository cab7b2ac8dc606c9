"""Word-vector serialization (the port of deeplearning4j_tpu/nlp/serializer.py;
the files are byte for byte the JAX package's for the same tables).

Reference: models/embeddings/loader/WordVectorSerializer.java — text format
(one `word v1 v2 ...` line per word) and the Google word2vec binary format
(header "V D\\n", then per word: name + space + D little-endian float32s).
"""
from __future__ import annotations

import struct

import numpy as np
import torch


class WordVectorSerializer:
    # ------------------------------------------------------------- text
    @staticmethod
    def write_word_vectors(model, path):
        """Text format (reference: WordVectorSerializer.writeWordVectors)."""
        W = model.lookup_table.get_weights()
        with open(path, "w", encoding="utf-8") as fh:
            for vw in model.vocab.vocab_words():
                vec = " ".join(f"{x:.6g}" for x in W[vw.index])
                fh.write(f"{vw.word} {vec}\n")

    @staticmethod
    def read_word_vectors(path):
        """Returns (words, matrix)."""
        words, rows = [], []
        with open(path, "r", encoding="utf-8") as fh:
            for line in fh:
                parts = line.rstrip("\n").split(" ")
                if len(parts) < 2:
                    continue
                words.append(parts[0])
                rows.append(np.array([float(x) for x in parts[1:]], np.float32))
        return words, np.stack(rows) if rows else np.zeros((0, 0), np.float32)

    # ----------------------------------------------------------- binary
    @staticmethod
    def write_binary(model, path):
        """Google word2vec binary format (reference:
        WordVectorSerializer.writeWordVectors binary branch)."""
        W = model.lookup_table.get_weights().astype("<f4")
        V, D = W.shape
        with open(path, "wb") as fh:
            fh.write(f"{V} {D}\n".encode())
            for vw in model.vocab.vocab_words():
                fh.write(vw.word.encode("utf-8") + b" ")
                fh.write(W[vw.index].tobytes())
                fh.write(b"\n")

    @staticmethod
    def read_binary(path):
        """Returns (words, matrix) from Google binary format (reference:
        WordVectorSerializer.loadGoogleModel)."""
        with open(path, "rb") as fh:
            header = b""
            while not header.endswith(b"\n"):
                header += fh.read(1)
            V, D = (int(x) for x in header.split())
            words, rows = [], []
            for _ in range(V):
                name = b""
                while True:
                    ch = fh.read(1)
                    if ch in (b" ", b""):
                        break
                    name += ch
                vec = np.frombuffer(fh.read(4 * D), dtype="<f4")
                nl = fh.read(1)
                if nl not in (b"\n", b""):
                    fh.seek(-1, 1)
                words.append(name.decode("utf-8"))
                rows.append(vec)
        return words, np.stack(rows)

    # --------------------------------------------------------- full model
    @staticmethod
    def load_static_model(path, binary=False, device=None):
        """Build a query-only WordVectors from a vectors file, its table on
        `device` (the card unless "cpu") (reference:
        WordVectorSerializer.loadStaticModel)."""
        from .sequence_vectors import WordVectors
        from .vocab import VocabCache, VocabWord
        from .embeddings import InMemoryLookupTable
        words, W = (WordVectorSerializer.read_binary(path) if binary
                    else WordVectorSerializer.read_word_vectors(path))
        cache = VocabCache()
        for w in words:
            cache.add_token(VocabWord(w, 1))
        cache.finalize_indices()
        # finalize sorts alphabetically on count ties — restore file order
        for i, w in enumerate(words):
            cache.word_for(w).index = i
        cache._by_index = [cache.word_for(w) for w in words]
        lt = InMemoryLookupTable(cache, W.shape[1] if W.size else 0,
                                 device=device)
        lt.syn0 = torch.as_tensor(np.array(W), device=lt.device)
        model = WordVectors()
        model.vocab = cache
        model.lookup_table = lt
        return model
