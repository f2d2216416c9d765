"""The training data pipeline (port of ``repro.data``): sharded token
datasets over paged storage, a host page cache managed by the paper's
policies (PBM / LRU / OPT from ``repro_torch.core.policies``), and
multi-stream loaders.  numpy on the host, as in the JAX package; the
batches it yields go to the card as the training driver's input."""

from .dataset import PAGE_TOKENS, DatasetSpec, generate_page, make_dataset_db
from .cache import HostPageCache
from .pipeline import DataStream, MultiStreamLoader

__all__ = [
    "DataStream", "DatasetSpec", "HostPageCache", "MultiStreamLoader",
    "PAGE_TOKENS", "generate_page", "make_dataset_db",
]
