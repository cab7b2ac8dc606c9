"""Record readers (the DataVec bridge's readers; the record -> DataSet
iterators of deeplearning4j_tpu/datasets/records/iterator.py are not
ported yet)."""
from .reader import (CollectionRecordReader, CSVRecordReader,
                     CSVSequenceRecordReader, ImageRecordReader,
                     ListStringRecordReader, RecordReader,
                     SequenceRecordReader)

__all__ = ["RecordReader", "SequenceRecordReader", "CSVRecordReader",
           "CSVSequenceRecordReader", "ImageRecordReader",
           "CollectionRecordReader", "ListStringRecordReader"]
