from repro_torch.optim.adamw import AdamWConfig, init_opt_state, apply_updates, global_norm  # noqa: F401
from repro_torch.optim.schedule import cosine_schedule  # noqa: F401
from repro_torch.optim.grad_compress import compress_roundtrip, crosspod_allgather_mean_int8  # noqa: F401
