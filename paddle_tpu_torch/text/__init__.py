"""``paddle.text`` (port of ``paddle_tpu/text/``): Viterbi decoding and the
text datasets."""
from .datasets import (Conll05st, Imdb, Imikolov, Movielens, UCIHousing,
                       WMT14, WMT16)
from .viterbi_decode import ViterbiDecoder, viterbi_decode

__all__ = ["Conll05st", "Imdb", "Imikolov", "Movielens", "UCIHousing",
           "WMT14", "WMT16", "ViterbiDecoder", "viterbi_decode"]
