"""Datasets (the port of ``paddle_tpu.dataset``; reference
``python/paddle/dataset/``: mnist, cifar, imdb, imikolov, movielens,
conll05, uci_housing, wmt14/16, flowers, voc2012, mq2007, sentiment,
each of which downloads, caches and yields samples).

Each module first looks for a local cache under
``$PADDLE_TPU_DATA_HOME`` (default ``~/.cache/paddle_tpu/dataset``) in the
reference's format and otherwise falls back to a deterministic
synthetic generator with the same sample shapes and vocabulary sizes,
the same samples as the JAX package's (``common.synthetic_rng``).
Nothing is downloaded unless ``PADDLE_TPU_DATASET_ONLINE=1`` asks for
it (``common.download``).
"""

from paddle_tpu_torch.dataset import common
from paddle_tpu_torch.dataset import mnist
from paddle_tpu_torch.dataset import cifar
from paddle_tpu_torch.dataset import uci_housing
from paddle_tpu_torch.dataset import imdb
from paddle_tpu_torch.dataset import imikolov
from paddle_tpu_torch.dataset import movielens
from paddle_tpu_torch.dataset import conll05
from paddle_tpu_torch.dataset import wmt14
from paddle_tpu_torch.dataset import wmt16
from paddle_tpu_torch.dataset import flowers
from paddle_tpu_torch.dataset import sentiment
from paddle_tpu_torch.dataset import mq2007
from paddle_tpu_torch.dataset import voc2012

__all__ = ["common", "mnist", "cifar", "uci_housing", "imdb", "imikolov",
           "movielens", "conll05", "wmt14", "wmt16", "flowers", "sentiment",
           "mq2007", "voc2012"]
