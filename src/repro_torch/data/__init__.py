from repro_torch.data.microbiome import (synthetic_abundance,  # noqa: F401
                                        synthetic_design,
                                        synthetic_sparse_counts,
                                        synthetic_study)
from repro_torch.data.slabcache import (SlabCache,  # noqa: F401
                                        SlabCacheError, SlabCacheWriter,
                                        SlabPrefetcher, build_slab_cache)
