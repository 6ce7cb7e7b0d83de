from repro_torch.optim.optimizers import (AdamState, Optimizer, adam,
                                          apply_updates, sgd)

__all__ = ["AdamState", "Optimizer", "adam", "apply_updates", "sgd"]
