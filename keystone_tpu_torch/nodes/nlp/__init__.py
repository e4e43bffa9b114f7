from keystone_tpu_torch.nodes.nlp.encoders import (
    CommonSparseFeatures,
    CountVectorizer,
    SparseFeatureVectorizer,
    WordFrequencyEncoder,
)
from keystone_tpu_torch.nodes.nlp.ngrams import NGramsFeaturizer
from keystone_tpu_torch.nodes.nlp.term_frequency import TermFrequency
from keystone_tpu_torch.nodes.nlp.tokenize import LowerCase, Tokenizer, Trim

__all__ = [
    "Trim",
    "LowerCase",
    "Tokenizer",
    "NGramsFeaturizer",
    "TermFrequency",
    "CommonSparseFeatures",
    "CountVectorizer",
    "SparseFeatureVectorizer",
    "WordFrequencyEncoder",
]
