from repro_torch.data.microbiome import (synthetic_abundance,  # noqa: F401
                                        synthetic_design, synthetic_study)
