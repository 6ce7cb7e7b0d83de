from repro_torch.optim.optimizers import (AdamState, Optimizer, adam,
                                          apply_updates, clip_by_global_norm,
                                          global_norm, sgd)

__all__ = ["AdamState", "Optimizer", "adam", "apply_updates",
           "clip_by_global_norm", "global_norm", "sgd"]
