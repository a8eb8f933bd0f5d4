from .pipeline import Prefetcher, host_slice, pack_documents, sharded_lm_iterator  # noqa: F401
from .synthetic import MarkovLM, gaussian_blobs  # noqa: F401
