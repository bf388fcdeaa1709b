from repro_torch.data.tokens import (SyntheticTokenDataset,  # noqa: F401
                                    make_token_batches)
from repro_torch.data.microbiome import (synthetic_abundance,  # noqa: F401
                                        synthetic_design,
                                        synthetic_sparse_counts,
                                        synthetic_study)
from repro_torch.data.slabcache import (SlabCache,  # noqa: F401
                                        SlabCacheError, SlabCacheWriter,
                                        SlabPrefetcher, build_slab_cache)
from repro_torch.data.loader import (PrefetchLoader,  # noqa: F401
                                    ShardedLoader)
