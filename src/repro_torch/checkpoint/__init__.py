from repro_torch.checkpoint.serializer import (  # noqa: F401
    CheckpointPayload, deserialize_tree, serialize_tree, tree_bytes,
)
from repro_torch.checkpoint.manager import CheckpointInfo, CheckpointManager  # noqa: F401
