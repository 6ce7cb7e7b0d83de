from repro_torch.checkpoint.io import (  # noqa: F401
    CORRUPT_ERRORS, latest_loadable, load_flat, load_latest, load_pytree,
    save_pytree, save_round)
from repro_torch.checkpoint.recovery import (  # noqa: F401
    load_latest_state, load_run_state, save_run_state)
