from repro_torch.checkpoint.checkpoint import (
    SaveHandle, is_committed, latest, prune, read_manifest, restore, save, save_async,
)

__all__ = [
    "SaveHandle", "is_committed", "latest", "prune", "read_manifest", "restore", "save",
    "save_async",
]
