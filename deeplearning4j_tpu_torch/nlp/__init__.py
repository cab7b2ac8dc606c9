"""NLP stack, the port of deeplearning4j_tpu/nlp/ (reference:
deeplearning4j-nlp-parent): embeddings (Word2Vec/ParagraphVectors/GloVe),
tokenization, vocab/Huffman, serialization, count vectorizers, CNN
sentence iterator.

The host parts (tokenizers, vocab, Huffman, pair generation,
co-occurrence counts) are copies of the JAX package's; the training steps
(embeddings.py, glove.py) run in torch on the models' device, the card
unless `device="cpu"`.
"""
from .tokenization import (DefaultTokenizer, NGramTokenizer,
                           DefaultTokenizerFactory, NGramTokenizerFactory,
                           CommonPreprocessor, LowCasePreProcessor,
                           EndingPreProcessor, StopWords)
from .text import (SentenceIterator, CollectionSentenceIterator,
                   BasicLineIterator, LineSentenceIterator, FileSentenceIterator,
                   LabelledDocument, LabelsSource, LabelAwareIterator,
                   SimpleLabelAwareIterator)
from .vocab import VocabWord, VocabCache, VocabConstructor, Huffman
from .embeddings import InMemoryLookupTable, WeightLookupTable
from .sequence_vectors import SequenceVectors, Word2Vec, ParagraphVectors, WordVectors
from .glove import Glove
from .serializer import WordVectorSerializer
from .bagofwords import BagOfWordsVectorizer, TfidfVectorizer
from .cnn_sentence import CnnSentenceDataSetIterator

__all__ = [
    "DefaultTokenizer", "NGramTokenizer", "DefaultTokenizerFactory",
    "NGramTokenizerFactory", "CommonPreprocessor", "LowCasePreProcessor",
    "EndingPreProcessor", "StopWords",
    "SentenceIterator", "CollectionSentenceIterator", "BasicLineIterator",
    "LineSentenceIterator", "FileSentenceIterator", "LabelledDocument",
    "LabelsSource", "LabelAwareIterator", "SimpleLabelAwareIterator",
    "VocabWord", "VocabCache", "VocabConstructor", "Huffman",
    "InMemoryLookupTable", "WeightLookupTable",
    "SequenceVectors", "Word2Vec", "ParagraphVectors", "WordVectors", "Glove",
    "WordVectorSerializer", "BagOfWordsVectorizer", "TfidfVectorizer",
    "CnnSentenceDataSetIterator",
]
