"""Batched serving: prefill, then token-by-token decode over a KV cache
(reduced gemma3 with its 5:1 local:global attention), through the serving
launcher (the port of the reference's ``examples/serve_batched.py``).

    PYTHONPATH=src python -m repro_torch.examples.serve_batched [--device cpu]
"""
from __future__ import annotations

from repro_torch.examples import parse_device
from repro_torch.launch import serve


def main(device=None, arch: str = "gemma3-4b", reduced: bool = True, batch: int = 4,
         prompt_len: int = 32, gen: int = 16) -> dict:
    """``repro_torch.launch.serve.main`` with these arguments; returns its
    result."""
    argv = ["--arch", arch, "--batch", str(batch), "--prompt-len", str(prompt_len),
            "--gen", str(gen)] + (["--reduced"] if reduced else [])
    return serve.main(argv + ([] if device is None else ["--device", str(device)]))


def cli(argv=None):
    return main(parse_device(__doc__, argv))


if __name__ == "__main__":
    cli()
