from repro_torch.data.pipeline import (Cursor, EpochLoader, epoch_permutation, microbatches,
                                       prefetch, put_global_batch)
from repro_torch.data.synthetic import (ArrayDataset, TokenStream, imagelike_classification,
                                        sigmoid_synthetic)

__all__ = [
    "ArrayDataset",
    "TokenStream",
    "sigmoid_synthetic",
    "imagelike_classification",
    "Cursor",
    "EpochLoader",
    "epoch_permutation",
    "microbatches",
    "prefetch",
    "put_global_batch",
]
