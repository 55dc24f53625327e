from repro_torch.optim.optimizers import (Optimizer, adamw, merge_state,
                                          sgd, slice_state)

__all__ = ["Optimizer", "adamw", "merge_state", "sgd", "slice_state"]
