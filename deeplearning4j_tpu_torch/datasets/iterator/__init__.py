"""DataSet iterators of the port."""
from .base import (AsyncDataSetIterator, DataSetIterator,
                   DevicePrefetchIterator, ExistingDataSetIterator,
                   INDArrayDataSetIterator, IteratorDataSetIterator,
                   ListDataSetIterator, MultipleEpochsIterator,
                   SamplingDataSetIterator, as_iterator)

__all__ = ["AsyncDataSetIterator", "DataSetIterator",
           "DevicePrefetchIterator", "ExistingDataSetIterator",
           "INDArrayDataSetIterator", "IteratorDataSetIterator",
           "ListDataSetIterator", "MultipleEpochsIterator",
           "SamplingDataSetIterator", "as_iterator"]
