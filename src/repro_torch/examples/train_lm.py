"""End to end: train a small LM for a few hundred steps on the
deterministic Markov stream, with checkpoint and restart, through the
training launcher (the port of the reference's ``examples/train_lm.py``).

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300 --resume

Arguments other than ``--device`` go to ``repro_torch.launch.train`` after
the defaults, so they override them.  The default checkpoint directory is
``repro_torch_ckpt`` under the temporary directory (``/tmp`` unless
``TMPDIR`` says otherwise), apart from the reference's ``/tmp/repro_ckpt``,
so that a resume never reads a checkpoint of the JAX package.
"""
from __future__ import annotations

import os
import tempfile

from repro_torch.examples import parse_device
from repro_torch.launch import train


def default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


def main(device=None, arch: str = "mistral-nemo-12b", reduced: bool = True, steps: int = 200,
         batch: int = 8, seq: int = 128, ckpt_dir: str | None = None, ckpt_every: int = 50,
         extra=()) -> dict:
    """``repro_torch.launch.train.main`` with these arguments, then
    ``extra`` (e.g. ``["--resume"]``); returns its result."""
    argv = ["--arch", arch, "--steps", str(steps), "--batch", str(batch), "--seq", str(seq),
            "--ckpt-dir", ckpt_dir or default_ckpt_dir(), "--ckpt-every", str(ckpt_every)]
    argv += ["--reduced"] if reduced else []
    argv += [] if device is None else ["--device", str(device)]
    return train.main(argv + list(extra))


def cli(argv=None):
    dev, rest = parse_device(__doc__, argv, passthrough=True)
    return main(dev, extra=rest)


if __name__ == "__main__":
    cli()
